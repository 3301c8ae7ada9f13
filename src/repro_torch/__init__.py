"""PyTorch/CUDA port of the DAS reproduction (see `repro` for the JAX
reference). Entry points run on the GPU unless the caller passes
`device="cpu"`."""
