"""Op layer: plain PyTorch ops, and the wrappers of the CUDA kernels.

    ref_ops.py      — plain reference math (rmsnorm, RoPE, attention, ...)
    linear.py       — plain-weight linear over stacked [L, K, N] weights
    paged_append.py — paged KV writes: CUDA kernels + plain versions
    sampling.py     — greedy / temperature / top-k / top-p / min-p sampling
    cuda_build.py   — builds csrc/*.cu into one ctypes-loaded library
    attention/      — flash prefill + paged flash decode kernels, dispatch

Each kernel wrapper launches its CUDA kernel for CUDA tensors and takes
its plain version (``*_ref``) only for CPU tensors.
"""
