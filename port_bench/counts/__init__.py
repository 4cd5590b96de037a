"""Operations and bytes of the work, computed from shapes: the model FLOPs
of the networks (`model`), the work of each hand-written kernel's call
(`kernels`), and what a kind of system runs of them (`<arch>`)."""
