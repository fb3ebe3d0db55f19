"""On-disk merge of IVF shards (counterpart of faiss_tpu/contrib/ondisk.py;
the reference's contrib/ondisk.py merge_ondisk and
invlists/OnDiskInvertedLists.h).

The reference merges trained IVF shards into a memory-mapped ivfdata file so
that the merged index never sits whole in RAM. The contract here is
faiss_tpu's: the shards' payloads are mapped in place (the container's
``_mmap_npz``, as IO_FLAG_MMAP maps them), the merged entry arrays are
streamed chunk by chunk into an uncompressed npz file, and the target index
takes memory maps of that file as its host lists, through the path every
change of the lists takes (its device layouts are dropped and staged again
at its next search). The host holds one chunk at a time, not the index.
"""

from __future__ import annotations

import zipfile
from typing import Optional, Sequence

import numpy as np
from numpy.lib import format as npformat

from ..io import _mmap_npz, read_index
from ..ivflib import extract_index_ivf


class NpzStreamWriter:
    """Write arrays into an uncompressed .npz without holding them in RAM
    (the container format write_index uses — so the result is mmappable)."""

    def __init__(self, fname: str):
        self.zf = zipfile.ZipFile(fname, "w", zipfile.ZIP_STORED)

    def write_stream(self, name, dtype, shape, chunks) -> None:
        dtype = np.dtype(dtype)
        header = {
            "descr": npformat.dtype_to_descr(dtype),
            "fortran_order": False,
            "shape": tuple(int(s) for s in shape),
        }
        with self.zf.open(name + ".npy", "w", force_zip64=True) as s:
            npformat.write_array_header_2_0(s, header)
            total = 0
            for chunk in chunks:
                chunk = np.ascontiguousarray(chunk, dtype)
                s.write(chunk.tobytes())
                total += len(chunk)
        if total != shape[0]:
            raise ValueError(f"{name}: wrote {total} rows, expected {shape[0]}")

    def write(self, name, array) -> None:
        self.write_stream(name, array.dtype, array.shape, [array])

    def close(self) -> None:
        self.zf.close()


def merge_ondisk(
    trained_index,
    shard_fnames: Sequence[str],
    ivfdata_fname: Optional[str] = None,
    chunk_rows: int = 1 << 18,
) -> None:
    """Merge shard index files into ``trained_index``
    (reference: contrib/ondisk.py:13 merge_ondisk).

    With ``ivfdata_fname`` the merged entry arrays are streamed to that file
    and attached as memory maps (OnDiskInvertedLists semantics: the host's
    memory stays bounded); without it the shards are read onto the index's
    device and merged in RAM.
    """
    ivf0 = extract_index_ivf(trained_index)

    if ivfdata_fname is None:
        for fname in shard_fnames:
            shard = read_index(fname, device=ivf0.device)
            ivf0.merge_from(extract_index_ivf(shard))
        trained_index.ntotal = ivf0.ntotal
        return

    # lazily map every shard, locate its entry arrays
    parts = []
    ntotal = 0
    for fname in shard_fnames:
        arrays = _mmap_npz(fname)
        # entry arrays live under the (possibly nested) ivf path: find the
        # unique '<path>/listnos' key
        keys = [k for k in arrays if k.endswith("/listnos")]
        if len(keys) != 1:
            raise ValueError(f"{fname}: expected one IVF payload, got {keys}")
        base = keys[0][: -len("/listnos")]
        part = {
            "codes": arrays.get(f"{base}/codes"),
            "listnos": arrays[f"{base}/listnos"],
            "ids": arrays[f"{base}/ids"],
        }
        ntotal += len(part["ids"])
        parts.append(part)

    def chunks_of(field):
        for part in parts:
            a = part[field]
            for s in range(0, len(a), chunk_rows):
                yield a[s : s + chunk_rows]

    w = NpzStreamWriter(ivfdata_fname)
    first = parts[0]
    if first["codes"] is not None:
        w.write_stream(
            "codes",
            first["codes"].dtype,
            (ntotal,) + first["codes"].shape[1:],
            chunks_of("codes"),
        )
    w.write_stream("listnos", np.int32, (ntotal,), chunks_of("listnos"))
    w.write_stream("ids", np.int64, (ntotal,), chunks_of("ids"))
    w.close()

    merged = _mmap_npz(ivfdata_fname)
    if "codes" in merged:
        ivf0._codes_host = merged["codes"]
    ivf0._listnos_host = merged["listnos"]
    ivf0._ids_host = merged["ids"]
    ivf0.ntotal = ntotal
    ivf0._drop_caches()
    trained_index.ntotal = ivf0.ntotal
