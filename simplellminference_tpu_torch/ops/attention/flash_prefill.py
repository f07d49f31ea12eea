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
``launches`` and in :data:`CAP_LAUNCHES` by (form, head dim). Sinks are
not ported yet.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.ops import cuda_build, ref_ops
from simplellminference_tpu_torch.ops.attention import prefill_tiles

HEAD_DIMS = (32, 64, 128, 256)
# the forms of this module that take head_dim 256 (Gemma), and their
# launches at that head dim (each also counts in its form's ``launches``)
D256_FORMS = ("flash_prefill", "flash_prefill_window")
D256_LAUNCHES = {"flash_prefill": 0, "flash_prefill_window": 0}
# launches with the soft cap, by (form, head dim) (each also counts in its
# form's ``launches``)
CAP_LAUNCHES: dict = {}


def count_launch(form: str, d: int, logit_cap, d256: dict) -> None:
    """One launch of ``form`` at head dim ``d``: in ``d256`` at D 256, in
    :data:`CAP_LAUNCHES` with a soft cap. The paged modules count theirs
    here too."""
    if d == 256:
        d256[form] += 1
    if logit_cap:
        CAP_LAUNCHES[form, d] = CAP_LAUNCHES.get((form, d), 0) + 1


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
                      logit_cap: float | None = None) -> torch.Tensor:
    """Plain version: causal reference attention (f32 softmax), keys
    within ``window`` of each query when given, scores soft-capped by
    ``logit_cap`` before the mask.
    q: [B, S, N, D]; k/v: [B, S, kvN, D] -> [B, S, N, D]."""
    if q.is_cuda:
        flash_prefill_ref.cuda_calls += 1
    s = q.shape[1]
    mask = ref_ops.causal_mask(s, s, window=window,
                               device=q.device)[None, None]
    return ref_ops.attention(q, k, v, mask, scale=sm_scale,
                             logit_cap=logit_cap)


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
                  logit_cap: float | None = None) -> torch.Tensor:
    """Causal self-attention of a (right-padded) prompt.

    q: [B, S, N, D]; k/v: [B, S, kvN, D] (bsnd; GQA by ``head // group``)
    -> [B, S, N, D] in q's dtype. ``sm_scale`` defaults to D**-0.5;
    ``window`` takes :func:`flash_prefill_window`; ``logit_cap`` > 0 is
    Gemma-2's soft cap (forms 3c, 3wc)."""
    if window is not None:
        return flash_prefill_window(q, k, v, window, sm_scale, logit_cap)
    cap = cap_value(logit_cap)
    if not q.is_cuda:
        return flash_prefill_ref(q, k, v, sm_scale, logit_cap=cap)
    out = _launch(q, k, v, sm_scale, 0, cap, "flash_prefill")
    flash_prefill.launches += 1
    count_launch("flash_prefill", q.shape[-1], cap, D256_LAUNCHES)
    return out


flash_prefill.launches = 0


def flash_prefill_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: int, sm_scale: float | None = None,
                         logit_cap: float | None = None) -> torch.Tensor:
    """The sliding-window form of :func:`flash_prefill`: query i attends
    keys i - window < j <= i."""
    window = window_size(window)
    cap = cap_value(logit_cap)
    cuda_build.check_head_dim(q.shape[-1], "flash_prefill_window",
                              D256_FORMS)
    if not q.is_cuda:
        return flash_prefill_ref(q, k, v, sm_scale, window, cap)
    out = _launch(q, k, v, sm_scale, window, cap, "flash_prefill_window")
    flash_prefill_window.launches += 1
    count_launch("flash_prefill_window", q.shape[-1], cap, D256_LAUNCHES)
    return out


flash_prefill_window.launches = 0


def _launch(q, k, v, sm_scale, window: int, cap, what: str) -> torch.Tensor:
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
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, rc, what)
    return out
