"""Import of pre-quantized HF checkpoints (AWQ / GPTQ, 4-bit) from a
tensor fetcher.

Counterpart of simplellminference_tpu/runtime/hf_quant.py:47-234, in
numpy and torch. Both formats store, per linear layer::

    qweight : packed uint4 ints        (AWQ: int32 [K, N/8], packed along N;
                                        GPTQ: int32 [K/8, N], packed along K)
    qzeros  : packed uint4 zero points (int32 [K/G, N/8])
    scales  : fp16 [K/G, N]

with ``w[k, n] = (q[k, n] - z[k//G, n]) * s[k//G, n]``, q and z in [0, 15].
They unpack into the port's split-half nibble layout with no dequant /
requant round trip: the codes shift by 8 into the signed int4 domain and
the zero points fold into ``zs = (z - 8) * s``, which the INT4 kernel's
zero-point form subtracts (``ops/matmul.quantized_matmul_int4_zs``).

Quirks (ecosystem conventions): AWQ packs nibbles in the order
[0, 2, 4, 6, 1, 3, 5, 7]; GPTQ stores ``qzeros`` minus one. GPTQ act-order
checkpoints (a non-trivial ``g_idx``) reorder K per layer and are
rejected. Reading a checkpoint directory (``load_quantized_dir``) waits
for the safetensors loaders; any ``fetch(name) -> np.ndarray`` that
raises KeyError for a missing name drives the import.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.core.device import (resolve_device,
                                                      torch_dtype)
from simplellminference_tpu_torch.ops.linear import QuantizedWeight
from simplellminference_tpu_torch.runtime import weights as W

_AWQ_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def read_quantization_config(model_dir: str) -> Optional[dict]:
    """The ``quantization_config`` block of config.json, or None."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("quantization_config")


def _unpack_u4(packed: np.ndarray, axis: int, order: np.ndarray
               ) -> np.ndarray:
    """int32 array -> uint4 values [0, 15], expanding ``axis`` by 8.

    ``order[j]``: the output offset of the value stored in bit slot j."""
    if packed.dtype == np.int32:                   # bit-preserving
        packed = np.ascontiguousarray(packed).view(np.uint32)
    u = packed.astype(np.uint32)
    vals = np.empty(u.shape + (8,), np.uint8)      # [..., 8] bit slots
    for j in range(8):                             # slot j -> offset order[j]
        vals[..., order[j]] = (u >> np.uint32(4 * j)) & np.uint32(0xF)
    # interleave into the target axis: [..., A, 8] -> [..., A*8]
    out = np.moveaxis(vals, -1, axis + 1 if axis >= 0 else axis)
    s = list(packed.shape)
    s[axis] *= 8
    return out.reshape(s).astype(np.int32)


def unpack_awq(qweight: np.ndarray, qzeros: np.ndarray, scales: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """AWQ "gemm" tensors -> (q_signed [K, N] int8, zs [G, N] f32, s f32):
    q_signed = q - 8, zs = (z - 8) * s, so (q - z) * s == q_signed * s - zs.
    """
    q = _unpack_u4(qweight, axis=-1, order=_AWQ_ORDER) - 8    # [K, N]
    z = _unpack_u4(qzeros, axis=-1, order=_AWQ_ORDER) - 8     # [G, N]
    s = scales.astype(np.float32)
    return q.astype(np.int8), z.astype(np.float32) * s, s


def unpack_gptq(qweight: np.ndarray, qzeros: np.ndarray, scales: np.ndarray,
                g_idx: Optional[np.ndarray] = None
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GPTQ tensors -> (q_signed [K, N] int8, zs [G, N] f32, s f32).

    qweight packs along K (sequential nibble order); qzeros store z - 1."""
    k8 = qweight.shape[0]
    if g_idx is not None:
        expect = np.arange(k8 * 8, dtype=g_idx.dtype) // (
            (k8 * 8) // scales.shape[0])
        if not np.array_equal(np.asarray(g_idx), expect):
            raise NotImplementedError(
                "GPTQ act-order (desc_act) checkpoints are not supported")
    seq = np.arange(8)
    q = _unpack_u4(qweight, axis=0, order=seq) - 8            # [K, N]
    z = _unpack_u4(qzeros, axis=-1, order=seq) + 1 - 8        # [G, N]
    s = scales.astype(np.float32)
    return q.astype(np.int8), z.astype(np.float32) * s, s


def pack_split_half(q_signed: np.ndarray) -> np.ndarray:
    """[K, N] int8 in [-8, 7] -> the split-half [K/2, N] nibble layout
    (``ref_ops.pack_int4``)."""
    k = q_signed.shape[0]
    lo, hi = q_signed[: k // 2], q_signed[k // 2:]
    return ((lo & 0xF) | (hi << 4)).astype(np.int8)


def _fetch_quantized(fetch: Callable[[str], np.ndarray], base: str,
                     method: str) -> tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    qw = fetch(base + ".qweight")
    qz = fetch(base + ".qzeros")
    sc = fetch(base + ".scales")
    if method == "awq":
        return unpack_awq(qw, qz, sc)
    gi = None
    try:
        gi = fetch(base + ".g_idx")
    except KeyError:
        pass
    return unpack_gptq(qw, qz, sc, gi)


def quantized_params_from_fetcher(
        cfg: ModelConfig, fetch: Callable[[str], np.ndarray], qcfg: dict,
        dtype=None, device=None) -> dict:
    """The params dict of an AWQ/GPTQ checkpoint given ``fetch(hf_name)``.

    The quantizable paths come back as INT4 :class:`QuantizedWeight`
    leaves with zero points (``zs``), never materialized as float weights;
    the other tensors (embedding, norms and, unless the checkpoint
    quantizes it, the LM head) load in ``dtype`` (default ``cfg.dtype``).
    Everything lands on ``device`` (CUDA unless ``device="cpu"``)."""
    method = qcfg.get("quant_method")
    bits = qcfg.get("bits", 4)
    if method not in ("awq", "gptq"):
        raise ValueError(f"unsupported quant_method {method!r}")
    if bits != 4:
        raise NotImplementedError(f"{method} bits={bits} (only 4 supported)")
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    pmap = W.llama_hf_param_map(cfg)
    params: dict = {}

    def load_q(hf_name: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not hf_name.endswith(".weight"):
            raise ValueError(f"{hf_name}: not a weight name")
        return _fetch_quantized(fetch, hf_name[: -len(".weight")], method)

    def load_plain(path: str, hf_name: str) -> torch.Tensor:
        t = torch.from_numpy(np.asarray(fetch(hf_name), np.float32).copy())
        if path in W._TRANSPOSED:
            t = t.T
        if cfg.model_type == "gemma" and path.endswith("norm"):
            t = t + 1.0
        return t.to(dt)

    def has(name: str) -> bool:
        try:
            fetch(name)
            return True
        except KeyError:
            return False

    for path, hf_names in pmap.items():
        per_layer = path.startswith("layers/")
        layers = range(cfg.num_layers) if per_layer else [None]
        quantized = path in W._QUANTIZABLE or (
            path == "lm_head" and has("lm_head.qweight"))
        stacked_q, stacked_zs, stacked_s, stacked_plain = [], [], [], []
        for li in layers:
            names = hf_names if isinstance(hf_names, tuple) else (hf_names,)
            names = tuple(nm.format(i=li) if li is not None else nm
                          for nm in names)
            ax = 0 if path in W._ROW_CONCAT else -1
            if quantized:
                qs, zss, ss = zip(*(load_q(nm) for nm in names))
                # fused projections concatenate along N (q/k/v, gate/up)
                q = np.concatenate(qs, axis=ax)
                zsc = np.concatenate(zss, axis=ax)
                sc = np.concatenate(ss, axis=ax)
                k, g = q.shape[0], sc.shape[0]
                gs = k // g
                if gs != k and (k // 2) % gs != 0:
                    raise NotImplementedError(
                        f"{path}: group size {gs} does not divide K/2="
                        f"{k // 2} (split-half packing)")
                stacked_q.append(pack_split_half(q))
                stacked_zs.append(zsc)
                stacked_s.append(sc)
            else:
                ts = [load_plain(path, nm) for nm in names]
                stacked_plain.append(torch.cat(ts, dim=ax))
        if quantized:
            def put(arrs):
                a = np.stack(arrs) if per_layer else arrs[0]
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            t = QuantizedWeight(q=put(stacked_q), scales=put(stacked_s),
                                bits=4, zs=put(stacked_zs))
        else:
            t = (torch.stack(stacked_plain) if per_layer
                 else stacked_plain[0]).contiguous().to(dev)
        W._set_path(params, path, t)
    return params
