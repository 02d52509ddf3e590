"""skirt9_tpu_torch — the PyTorch/CUDA port of skirt9_tpu.

The JAX package `skirt9_tpu` stays the reference; this package runs the same
Monte Carlo radiative-transfer flows with PyTorch tensors, and on an NVIDIA
H100 its hot loops run in hand-written CUDA C++ kernels (`csrc/`, built at
first use by `kernels/build.py`).

Slice covered so far: primary emission of a monochromatic point source
through a uniform Cartesian dust grid (the resident sweep, or the large-grid
XL contracts past 73^3) or a power-of-two octree or bintree (the multi-level
sweep), with forced scattering, HG phase function, peel-off to distant
SED/frame instruments and an optional one-bin radiation field. Everything
else raises NotImplementedError naming itself.

Rules of the package:
  * it imports neither jax nor any module of skirt9_tpu, not even a jax-free
    one: it keeps its own copies of the host modules it needs (`utils/fits`,
    `utils/constants`, `utils/unitsystem`, `utils/log`);
  * the device is always explicit (`Simulation(..., device=...)`);
  * random numbers are the reference's threefry streams, draw for draw
    (`ops/rng.py`), so a CPU run matches the JAX package to f32 rounding;
  * every kernel has a plain PyTorch version beside it, used only for
    tensors on the CPU; a CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
