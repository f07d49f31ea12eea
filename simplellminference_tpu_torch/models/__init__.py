"""Model graphs: the Llama decoder over paged KV, and the converter from
the JAX package's parameter tree."""
