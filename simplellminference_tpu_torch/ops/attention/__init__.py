"""Attention: flash prefill and paged flash decode (CUDA kernels with
plain PyTorch versions), and the dispatch the model calls."""
