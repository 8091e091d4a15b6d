"""The benchmark's plain reference: imports nothing of the program, of JAX or of the JAX package."""
