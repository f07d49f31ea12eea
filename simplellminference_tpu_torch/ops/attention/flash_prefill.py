"""Causal GQA flash attention over a prompt (prefill).

Counterpart of simplellminference_tpu/ops/attention/flash_prefill.py:102.
For CUDA tensors :func:`flash_prefill` launches the hand-written kernel of
``csrc/flash_prefill.cu``: in bf16 on the tensor cores (each 64-row tile
packs the positions x q heads of one kv head, :mod:`.prefill_tiles`; K/V
tiles through a cp.async ring up to the causal frontier; f32 online
softmax, P split into two bf16 parts for the PV product; the key walk
split over blocks when the tiles alone leave the card idle), in f32 with
FMAs; for CPU tensors it runs :func:`flash_prefill_ref`. Unlike the TPU
dispatcher, which sends S % 128 != 0 to the jnp reference, the kernel
takes every S.

The sliding-window form (``window``: query i attends keys with q_pos -
k_pos < window; flash_prefill.py:50-53, :76-77) is the same kernel walking
only the key tiles that reach the window band; on the card it is its own
wrapper, :func:`flash_prefill_window`, with its own launch count.

Gemma-2's soft cap (``logit_cap``: each score becomes
cap * tanh(s * scale * (1 / cap)) before the mask, flash_prefill.py:
67-68) is a compile-time flag of both kernels, so the uncapped forms run
the code they ran before; capped launches count in their form's
``launches`` and in :data:`CAP_LAUNCHES` by (form, head dim).

GPT-OSS's attention sinks (``sinks`` [N]: a learned logit per q head that
joins each row's softmax denominator and adds no value,
flash_prefill.py:29-43) are a pointer argument of both kernels: each
row's online softmax starts at (m, l) = (its head's sink, 1) instead of
(-1e30, 0) (forms 3s, 3ws); launches with sinks count in their form's
``launches`` and in :data:`SINK_LAUNCHES` by (form, head dim).

Shared-KV rows (absorbed MLA: the JAX package's whole-prompt prefill calls
the kernel with v = k, llama.py:713-717): form 3l,
:func:`flash_prefill_shared`, with its own launch count, at head dims 128
and 640 (DeepSeek-V2-Lite's latent row). Its kernels
(``csrc/flash_prefill_shared.cu`` over ``csrc/prefill_shared.cuh``) stage
each row tile once for both products and make the output in passes of 128
columns; no window, cap or sinks.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.ops import cuda_build, ref_ops
from simplellminference_tpu_torch.ops.attention import prefill_tiles

HEAD_DIMS = (32, 64, 128, 256)
# the launches of this module's forms at head_dim 256 (Gemma; each also
# counts in its form's ``launches``)
D256_LAUNCHES = {"flash_prefill": 0, "flash_prefill_window": 0}
# launches with the soft cap, and with attention sinks, by (form, head
# dim) (each also counts in its form's ``launches``)
CAP_LAUNCHES: dict = {}
SINK_LAUNCHES: dict = {}


def count_launch(form: str, d: int, logit_cap, d256: dict,
                 sinks=None) -> None:
    """One launch of ``form`` at head dim ``d``: in ``d256`` at D 256, in
    :data:`CAP_LAUNCHES` with a soft cap, in :data:`SINK_LAUNCHES` with
    sinks. The paged modules count theirs here too."""
    if d == 256:
        d256[form] += 1
    if logit_cap:
        CAP_LAUNCHES[form, d] = CAP_LAUNCHES.get((form, d), 0) + 1
    if sinks is not None:
        SINK_LAUNCHES[form, d] = SINK_LAUNCHES.get((form, d), 0) + 1


SINK_HEAD_DIMS = (32, 64, 128)   # the sink forms' head dims (no D 256)


def check_sinks_head_dim(sinks, d: int) -> None:
    """Raise NotImplementedError for sinks at a head dim the sink forms do
    not take (256: no model with sinks has it, and the tensor-core
    kernels' D-256 instantiations, at their register limit, are compiled
    without the seeding), on the CPU as on the card."""
    if sinks is not None and d not in SINK_HEAD_DIMS:
        raise NotImplementedError(f"attention sinks at head_dim {d} (the "
                                  f"sink forms take {SINK_HEAD_DIMS})")


def sink_values(sinks, n: int, device):
    """A layer's sinks, checked to be as the kernels take them and as the
    params hold them: f32 [n] contiguous on ``device`` (None stays None)."""
    if sinks is None:
        return None
    if tuple(sinks.shape) != (n,):
        raise ValueError(f"sinks {tuple(sinks.shape)}: one logit per q "
                         f"head ({n})")
    if (sinks.dtype != torch.float32 or sinks.device != torch.device(device)
            or not sinks.is_contiguous()):
        raise ValueError(f"sinks {sinks.dtype} on {sinks.device}: the "
                         f"kernels take f32 contiguous on {device}")
    return sinks


def cap_value(logit_cap) -> float | None:
    """A soft cap as a float > 0, or None for none (0 and None)."""
    if not logit_cap:
        return None
    cap = float(logit_cap)
    if not cap > 0:
        raise ValueError(f"logit soft cap {logit_cap} (must be > 0)")
    return cap


def window_size(window) -> int:
    """A sliding window as an int >= 1 (the kernels take 0 for none)."""
    w = int(window)
    if w < 1:
        raise ValueError(f"sliding window {window} (must be >= 1)")
    return w


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sm_scale: float | None = None,
                      window: int | None = None,
                      logit_cap: float | None = None,
                      sinks: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: causal reference attention (f32 softmax), keys
    within ``window`` of each query when given, scores soft-capped by
    ``logit_cap`` before the mask, each head's ``sinks`` logit in the
    softmax.
    q: [B, S, N, D]; k/v: [B, S, kvN, D] -> [B, S, N, D]."""
    if q.is_cuda:
        flash_prefill_ref.cuda_calls += 1
    s = q.shape[1]
    mask = ref_ops.causal_mask(s, s, window=window,
                               device=q.device)[None, None]
    return ref_ops.attention(q, k, v, mask, scale=sm_scale,
                             logit_cap=logit_cap, sinks=sinks)


flash_prefill_ref.cuda_calls = 0


def heads_contiguous(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each row's [heads, D] contiguous and, for the tensor-core
    kernel's 16-byte copies, its base and row strides 16-byte aligned (a
    contiguous copy otherwise)."""
    if (x.stride(-1) != 1 or x.stride(-2) != x.shape[-1]
            or x.data_ptr() % 16
            or any(st * x.element_size() % 16 for st in x.stride()[:2])):
        x = x.contiguous()
    return x


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sm_scale: float | None = None,
                  window: int | None = None,
                  logit_cap: float | None = None,
                  sinks: torch.Tensor | None = None) -> torch.Tensor:
    """Causal self-attention of a (right-padded) prompt.

    q: [B, S, N, D]; k/v: [B, S, kvN, D] (bsnd; GQA by ``head // group``)
    -> [B, S, N, D] in q's dtype. ``sm_scale`` defaults to D**-0.5;
    ``window`` takes :func:`flash_prefill_window`; ``logit_cap`` > 0 is
    Gemma-2's soft cap (forms 3c, 3wc); ``sinks`` [N] GPT-OSS's attention
    sinks (forms 3s, 3ws)."""
    if window is not None:
        return flash_prefill_window(q, k, v, window, sm_scale, logit_cap,
                                    sinks)
    check_sinks_head_dim(sinks, q.shape[-1])
    cap = cap_value(logit_cap)
    if not q.is_cuda:
        return flash_prefill_ref(q, k, v, sm_scale, logit_cap=cap,
                                 sinks=sinks)
    out = _launch(q, k, v, sm_scale, 0, cap, sinks, "flash_prefill")
    flash_prefill.launches += 1
    count_launch("flash_prefill", q.shape[-1], cap, D256_LAUNCHES, sinks)
    return out


flash_prefill.launches = 0


SHARED_HEAD_DIMS = (128, 640)   # form 3l's (absorbed MLA's latent lanes)


def flash_prefill_shared(q: torch.Tensor, kv: torch.Tensor,
                         sm_scale: float | None = None) -> torch.Tensor:
    """3l: causal self-attention of a (right-padded) prompt over its
    shared-KV rows (absorbed MLA), each row both the key and the value.
    q: [B, S, N, D]; kv: [B, S, kvN, D] -> [B, S, N, D] in q's dtype.
    Head dims 128 and 640."""
    b, s, n, d = q.shape
    if d not in SHARED_HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d} over shared-KV rows (form "
                                  f"3l takes {SHARED_HEAD_DIMS})")
    if not q.is_cuda:
        return flash_prefill_ref(q, kv, kv, sm_scale)
    kvn = kv.shape[2]
    if kv.shape != (b, s, kvn, d) or n % kvn:
        raise ValueError(f"kv {tuple(kv.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.dtype != kv.dtype or q.device != kv.device:
        raise ValueError("q and kv must share dtype and device")
    code = cuda_build.dtype_code(q.dtype)
    out = torch.empty((b, s, n, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    q, kv = heads_contiguous(q), heads_contiguous(kv)
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    splits, work = prefill_tiles.workspace(q, kvn, 0, s)
    lib = cuda_build.load()
    rc = lib.sli_flash_prefill_shared(
        q.data_ptr(), kv.data_ptr(), out.data_ptr(), q.stride(0),
        q.stride(1), kv.stride(0), kv.stride(1), b, s, n, n // kvn, d, scale,
        code, 0 if work is None else work.data_ptr(), splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, rc, "flash_prefill_shared")
    flash_prefill_shared.launches += 1
    return out


flash_prefill_shared.launches = 0


def flash_prefill_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: int, sm_scale: float | None = None,
                         logit_cap: float | None = None,
                         sinks: torch.Tensor | None = None) -> torch.Tensor:
    """The sliding-window form of :func:`flash_prefill`: query i attends
    keys i - window < j <= i."""
    window = window_size(window)
    cap = cap_value(logit_cap)
    check_sinks_head_dim(sinks, q.shape[-1])
    if not q.is_cuda:
        return flash_prefill_ref(q, k, v, sm_scale, window, cap, sinks)
    out = _launch(q, k, v, sm_scale, window, cap, sinks,
                  "flash_prefill_window")
    flash_prefill_window.launches += 1
    count_launch("flash_prefill_window", q.shape[-1], cap, D256_LAUNCHES,
                 sinks)
    return out


flash_prefill_window.launches = 0


def _launch(q, k, v, sm_scale, window: int, cap, sinks,
            what: str) -> torch.Tensor:
    b, s, n, d = q.shape
    kvn = k.shape[2]
    if k.shape != (b, s, kvn, d) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if n % kvn:
        raise ValueError(f"{n} heads do not group over {kvn} kv heads")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d} (kernel takes {HEAD_DIMS})")
    if not (q.dtype == k.dtype == v.dtype) or not (
            q.device == k.device == v.device):
        raise ValueError("q, k, v must share dtype and device")
    code = cuda_build.dtype_code(q.dtype)
    sinks = sink_values(sinks, n, q.device)
    out = torch.empty((b, s, n, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    q, k, v = (heads_contiguous(x) for x in (q, k, v))
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    splits, work = prefill_tiles.workspace(q, kvn, window, s)
    lib = cuda_build.load()
    rc = lib.sli_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        b, s, n, n // kvn, d, window, scale, cap or 0.0, code,
        0 if work is None else work.data_ptr(), splits,
        0 if sinks is None else sinks.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, rc, what)
    return out
