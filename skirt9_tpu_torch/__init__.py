"""skirt9_tpu_torch — the PyTorch/CUDA port of skirt9_tpu.

The JAX package `skirt9_tpu` stays the reference; this package runs the same
Monte Carlo radiative-transfer flows with PyTorch tensors, and on an NVIDIA
H100 its hot loops run in hand-written CUDA C++ kernels (`csrc/`, built at
first use by `kernels/build.py`).

Slices covered so far: primary emission of a point source (monochromatic,
or with a tabulated SED such as a blackbody) through a uniform Cartesian
dust grid (the resident sweep, or the large-grid XL contracts past 73^3) or
a power-of-two octree or bintree (the multi-level sweep), with forced
scattering, HG phase function, peel-off to distant SED/frame instruments and
a stored radiation field; and on uniform grids of the resident sweep,
equilibrium dust emission (`Simulation.run_with_dust_emission`: a multi-bin
radiation field filled from stratified bin-pure lane groups, optional
self-absorption iterations, a secondary launch with peel-off); lane refill
on every engine (`Simulation.refill_events`); the port's own ski loader
(`config/ski.py`: the item types of the golden bench1, bench1h and bench2)
and CLI (`python -m skirt9_tpu_torch model.ski`), with the temperature and
radiation-field probes. The gather and row-lookup probes of `tools/` have
entry points in `skirt9_tpu_torch/tools/`. Everything else raises
NotImplementedError naming itself.

Rules of the package:
  * it imports neither jax nor any module of skirt9_tpu, not even a jax-free
    one: it keeps its own copies of the host modules it needs (`utils/fits`,
    `utils/constants`, `utils/unitsystem`, `utils/log`, `utils/units`,
    `utils/filepaths`, `utils/cosmology`);
  * entry points run on the card unless the caller asks for the CPU
    (`Simulation(..., device="cpu")`, `--device cpu`); without a GPU the
    default raises, it never falls back to the CPU;
  * random numbers are the reference's threefry streams, draw for draw
    (`ops/rng.py`), so a CPU run matches the JAX package to f32 rounding;
  * every kernel has a plain PyTorch version beside it, used only for
    tensors on the CPU; a CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
