"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Mirrors ``repro``'s module names so each module's counterpart is found
under the same path. It imports ``torch`` and ``numpy`` and nothing of
JAX or of ``repro``: where it needs a pure-Python module of ``repro``
(the control plane, configs, shapes) it keeps its own copy. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
