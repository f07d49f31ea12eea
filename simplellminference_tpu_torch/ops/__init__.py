"""Op layer: plain PyTorch ops, and the wrappers of the CUDA kernels.

    ref_ops.py      — plain reference math (rmsnorm, RoPE, attention,
                      INT8 quantize / dequantize / matmul)
    linear.py       — linear over plain or INT8 (QuantizedWeight) weights,
                      stacked [L, K, N] with a layer index
    matmul.py       — quantized_matmul: INT8 dequant + matmul kernel
    qkv_fused.py    — fused_qkv_append: rmsnorm + qkv + RoPE + paged append
    ffn_fused.py    — fused_ffn: rmsnorm + gate_up + SwiGLU + down + residual
    paged_append.py — paged KV writes: CUDA kernels + plain versions
    sampling.py     — greedy / temperature / top-k / top-p / min-p sampling
    cuda_build.py   — builds csrc/*.cu into one ctypes-loaded library
    attention/      — flash prefill + paged flash decode kernels, dispatch

Each kernel wrapper launches its CUDA kernel for CUDA tensors and takes
its plain version (``*_ref``) only for CPU tensors.
"""
