"""Hopper kernels of the reuse decode path, their plain twins and the
accounting around them. Importing this package builds nothing: a kernel
library is compiled at its first launch (`backend.library`)."""
