"""portbench: the benchmark of faiss_tpu_torch on one card."""
