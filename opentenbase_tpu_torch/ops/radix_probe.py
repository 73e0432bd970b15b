"""Radix hash-join probe: the Hopper kernel that replaces the reference's
Pallas kernel (opentenbase_tpu/ops/pallas_join.py, ``build_probe`` behind
``probe_radix_pallas``).

``radix_probe`` is the wrapper of the CUDA kernel in csrc/radix_probe.cu;
``radix_probe_plain`` beside it is the same function in plain PyTorch.
CPU tensors take the plain version; CUDA tensors launch the kernel
(counted in ``radix_probe.launches``) or raise.

Contract (ops/join.probe_radix_first's, over a table from
ops/join.build_radix_table): per probe row, ``matched`` is True when its
bucket holds a valid slot with an equal key and the row is real, and
``bidx`` is that slot's build row (the first such slot, in the table's
(key, row) order); both are 0 on a miss.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from opentenbase_tpu_torch.ops import cuda_build
from opentenbase_tpu_torch.ops.join import probe_radix_first
from opentenbase_tpu_torch.ops.scan_agg import sector_bytes


def radix_probe_plain(tkeys, tvalid, tbidx, probe_key, probe_real,
                      partitions: int, bucket: int):
    """``probe_radix_first`` with ``bidx`` 0 on a miss."""
    m, bi = probe_radix_first(
        tkeys, tvalid, tbidx, probe_key, probe_real, partitions, bucket
    )
    return m, torch.where(m, bi, torch.zeros_like(bi))


def probe_bytes(tkeys, probe_key, probe_real) -> int:
    """Bytes the probe must move for these inputs: every row's real flag
    read and its matched flag and bidx written; the keys of the real
    rows, in the 32-byte sectors that hold one; the table read once."""
    n = probe_key.shape[0]
    keys = sector_bytes(probe_real.reshape(1, -1), probe_key.element_size())
    return n * (1 + 1 + 4) + keys + tkeys.numel() * (8 + 1 + 4)


_lib = None
_lib_mu = threading.Lock()


def _load():
    global _lib
    with _lib_mu:
        if _lib is None:
            lib = cuda_build.load("radix_probe.cu")
            lib.radix_probe_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.radix_probe_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def vector_ok(*rows: torch.Tensor) -> bool:
    """Whether the kernel may move each row array in 16-byte accesses:
    every one starts on a 16-byte boundary. A view that does not (a probe
    starting at an offset) takes per-row accesses."""
    return all(x.data_ptr() % 16 == 0 for x in rows)


def _check_args(tkeys, tvalid, tbidx, probe_key, probe_real, P, B):
    if P < 1 or P & (P - 1):
        raise ValueError(f"partitions must be a power of two, not {P}")
    if B < 1:
        raise ValueError(f"bucket must be positive, not {B}")
    slots = P * B + 1
    if slots >= 2**31:
        raise ValueError(f"table of {slots} slots: int32 bidx overflows")
    for name, x, dt in (("tkeys", tkeys, torch.int64),
                        ("tvalid", tvalid, torch.bool),
                        ("tbidx", tbidx, torch.int32)):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, not {x.dtype}")
        if x.shape != (slots,):
            raise ValueError(f"{name} must be [P*B+1] = [{slots}]")
    if probe_key.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"probe keys must be int32 or int64, not "
                        f"{probe_key.dtype}")
    if probe_real.dtype != torch.bool:
        raise TypeError("probe_real must be bool")
    if probe_key.dim() != 1 or probe_real.shape != probe_key.shape:
        raise ValueError("probe_key and probe_real must be [n]")


def radix_probe(tkeys, tvalid, tbidx, probe_key, probe_real,
                partitions: int, bucket: int):
    """(matched [n] bool, bidx [n] int32) of each probe row against the
    bucket-padded table (see the module docstring). ``probe_key`` is int32
    or int64; the kernel widens it itself."""
    P, B = int(partitions), int(bucket)
    _check_args(tkeys, tvalid, tbidx, probe_key, probe_real, P, B)
    dev = probe_key.device
    if dev.type == "cpu":
        return radix_probe_plain(
            tkeys, tvalid, tbidx, probe_key, probe_real, P, B
        )
    if dev.type != "cuda":
        raise RuntimeError(f"radix_probe: no kernel for {dev}")
    for x in (tkeys, tvalid, tbidx, probe_real):
        if x.device != dev:
            raise ValueError("radix_probe: tensors on different devices")
    tkeys, tvalid, tbidx = (
        tkeys.contiguous(), tvalid.contiguous(), tbidx.contiguous()
    )
    probe_key, probe_real = probe_key.contiguous(), probe_real.contiguous()
    n = probe_key.shape[0]
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    bidx = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return matched, bidx
    lib = _load()
    vec = vector_ok(probe_key, probe_real, matched, bidx)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.radix_probe_launch(
            tkeys.data_ptr(), tvalid.data_ptr(), tbidx.data_ptr(),
            probe_key.data_ptr(), int(probe_key.dtype == torch.int64),
            probe_real.data_ptr(), n, P, B, int(vec), matched.data_ptr(),
            bidx.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"radix_probe kernel launch failed: CUDA error {rc}"
        )
    radix_probe.launches += 1
    return matched, bidx


radix_probe.launches = 0
