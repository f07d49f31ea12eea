"""Runtime layer: post-hoc weight quantization (checkpoint loaders come
with the checkpoint slice)."""
