"""The benchmark's plain reference: float32 PyTorch with TF32 off, and
NumPy.  It imports nothing of the program under test and nothing of JAX;
it takes the benchmark's own weights and token batches and works out
again everything the program derives from them."""
