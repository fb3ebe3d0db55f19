"""Application-layer utilities (counterpart of faiss_tpu/contrib/; the
reference's contrib/)."""
