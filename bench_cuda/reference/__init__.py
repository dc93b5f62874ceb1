"""The plain reference: NumPy and PyTorch code that works out, from the
benchmark's own inputs, what the program's outputs should be.  It
imports nothing of the program (neither lightgbm_tpu_torch nor the JAX
package nor jax): it reads the program's outputs (trees, scores) only to
judge them, and bins, routes and sums by LightGBM's documented rules
itself.  A configuration names its objective's module here."""
