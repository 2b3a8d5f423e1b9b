"""The benchmark's plain reference: float32 PyTorch, written from the
published architectures. It imports nothing of the program under test and
nothing of JAX."""
