"""Hand-written CUDA kernels of the port, one package per TPU kernel of
``repro.kernels`` that the port carries so far. Each package holds the
kernel's wrapper, its plain PyTorch version and a launch count; the CUDA
sources live in ``repro_torch/csrc`` and build through ``_build``."""
