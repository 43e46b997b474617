"""PyTorch/CUDA port of `repro` (Harpagon) for one NVIDIA H100.

Mirrors `repro`'s layout.  Imports torch and numpy, never jax and never
anything under `repro`: the pure-Python layers it needs (configs, the
planner, the serving simulator, the analytic profiler) are copies, each
naming its original on its first line.  Kernels live in `kernels/`; entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
