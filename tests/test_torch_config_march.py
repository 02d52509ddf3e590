"""Configurations on the scan march, draw for draw against the reference's
default CPU path (its scan march: it sweeps only on its accelerator), with
no SKIRT9_TPU_FORCE_SWEEP.

Each case loads a reduced golden ski file through the reference's
`load_ski`, converts it with `bridge.simulation(..., march=True)` (the
port keeps no sweep tables where the reference has none, so that neither
launches bin-pure strata) and runs both packages on one torch thread; a spy
on the plain march shows the port took it, and no kernel launched. The
SEDs, frames and RF must agree within 1e-5 of each maximum; measured:

- bench1 with `explicitAbsorption="true"` at 16^3 (a uniform grid whose
  resident sweep the gate declines): SED exact, frames 6e-10;
- bench1 on a 16^3 `SymPowMesh` (a meshed CartesianGrid, no sweep takes
  it): SED exact, frames 1.2e-9;
- bench4 with its RF cut to 4 bins, 2,048 packets, 3 events, with dust
  emission, the port's `raster_fallback` off (the exact Voronoi walk) and
  the reference as it is: RF 1.4e-6, SEDs 6e-7, frames 2.3e-6, L_dust
  1.4e-7 relative;
- bench2 at 8^3 with explicit absorption, its 25-bin RF and one
  self-absorption iteration: RF 3.5e-7, frames 7.6e-7;
- bench6 (Lyman-alpha) with the gas temperature rising from 1x to 2x over
  the occupied cells, 2,048 packets, 8 events: SEDs 1.0e-7 (no tan/atan
  flip of the rejection sampler in this run, ROADMAP queue C);
- bench5's moving outflow with the MRN dust mix (kinematics with
  wavelength-dependent cross sections), 8^3, 6 events: 7.9e-7.

Trees on the march (the reference's CPU tree has no leaf map, and neither
has the port's here: both locate by descent):

- bench3 at maxLevel 4 (2,122 leaves) with explicit absorption, its RF cut
  to 4 bins and one self-absorption iteration, 2,048 packets, 4 events:
  RF 7.0e-7, SEDs 1.2e-6;
- bench6 on a maxLevel-3 density octree with the gas temperature rising
  1x to 2x over the occupied cells (Lya on the octree march), 2,048
  packets, 8 events;
- bench7 (X-ray gas) on a maxLevel-3 octree, 2,048 packets, 8 events;
- bench5's moving outflow on a maxLevel-3 octree (polarization and
  kinematics on the octree march), 1,024 packets, 6 events: the
  unpolarized light within 1e-5, the polarized sums within
  `chip_smoke.B5_BOUNDS` (the reference's azimuth is chaotic to an ulp,
  ROADMAP C).
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import march as mr

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

EXACT = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gaps(out_r, out_p):
    """The RF's and each SED and frame kind's largest gap, as a share of
    the reference's maximum."""
    gaps = {}
    pairs = [("rf", out_r[0], out_p[0])] if out_r[0] is not None else []
    for k in ("sed", "frame"):
        if k not in out_r[1][0]:
            continue
        for kind in range(np.asarray(out_r[1][0][k]).shape[0]):
            pairs.append((f"{k}{kind}", out_r[1][0][k][kind],
                          out_p[1][0][k][kind]))
    for name, a, b in pairs:
        a = np.asarray(a, np.float64)
        b = b.double().numpy()
        m = np.abs(a).max()
        gaps[name] = 0.0 if m == 0 else float(np.abs(a - b).max() / m)
        assert m > 0 or np.abs(b).max() == 0, name
    return gaps


def _run(monkeypatch, ref, port=None, dust=False):
    """Both runs, the port's through a spy on the plain march; returns
    (reference output, port output, march calls)."""
    port = port or bridge.simulation(ref, "cpu", march=True)
    calls = []
    plain = mr.march_geometry_plain

    def spy(*args):
        calls.append(args[0])
        return plain(*args)

    monkeypatch.setattr(mr, "march_geometry_plain", spy)
    run = (lambda s: s.run_with_dust_emission(verbose=False)) if dust else \
        (lambda s: s.run_primary(verbose=False))
    out_r = run(ref)
    kb.reset_launches()
    out_p = run(port)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    assert calls and all(g is port.grid for g in calls)
    return out_r, out_p, len(calls)


def _load(name, tmp_path, edits, **kw):
    return ref_load_ski(chip_smoke.edited_ski(name, tmp_path, edits), **kw)


@pytest.mark.parametrize("case", ["explicit_absorption", "sympow_mesh"])
def test_bench1_on_the_march(case, tmp_path, monkeypatch):
    edits = ({'numBins="32"': 'numBins="16"',
              'forceScattering="true"':
              'forceScattering="true" explicitAbsorption="true"'}
             if case == "explicit_absorption" else
             {'<LinMesh numBins="32"/>':
              '<SymPowMesh numBins="16" ratio="8"/>'})
    ref = _load("bench1", tmp_path, edits, num_packets=4096,
                batch_size=4096, max_events=8)
    port = bridge.simulation(ref, "cpu", march=True)
    assert type(port.grid).__name__ == type(ref.grid).__name__ == (
        "UniformCartesianGrid" if case == "explicit_absorption"
        else "CartesianGrid")
    gate = lc.sweep_gate(port.medium, port.options,
                         bridge.simulation(ref, "cpu")._sweep_tabs, None,
                         4096)
    assert not gate.use_sweep and gate.why
    out_r, out_p, _ = _run(monkeypatch, ref, port)
    gaps = _gaps(out_r, out_p)
    assert max(gaps.values()) <= EXACT, gaps


def test_bench4_exact_walk_with_dust_emission(tmp_path, monkeypatch):
    ref = _load("bench4", tmp_path,
                {'numWavelengths="25"': 'numWavelengths="4"'},
                num_packets=2048, batch_size=2048, max_events=3)
    assert ref.options.raster_fallback and ref._sweep_tabs is None
    port = bridge.simulation(ref, "cpu")
    assert type(port._sweep_tabs).__name__ == "MLTables"   # its raster
    port = dataclasses.replace(port, options=dataclasses.replace(
        port.options, raster_fallback=False))
    assert port._sweep_tabs is None
    assert port._strata_for(port.sources[0], port.options) is None
    out_r, out_p, calls = _run(monkeypatch, ref, port, dust=True)
    assert calls > 0
    gaps = _gaps(out_r, out_p)
    assert max(gaps.values()) <= EXACT, gaps
    assert out_p[2]["iterations"] == out_r[2]["iterations"]
    assert out_p[2]["L_dust"] == pytest.approx(out_r[2]["L_dust"], rel=1e-5)


def test_bench2_explicit_absorption_multi_bin_rf(tmp_path, monkeypatch):
    ref = _load("bench2", tmp_path, {
        'numBins="32"': 'numBins="8"',
        'forceScattering="true"':
        'forceScattering="true" explicitAbsorption="true"'},
        num_packets=4096, batch_size=4096, max_events=4)
    ref.iterate_secondary, ref.max_iterations = True, 1
    assert ref.options.explicit_absorption and len(ref.rf_borders) == 26
    out_r, out_p, _ = _run(monkeypatch, ref, dust=True)
    assert out_p[0].shape == (512, 25)
    gaps = _gaps(out_r, out_p)
    assert max(gaps.values()) <= EXACT, gaps
    assert out_p[2]["iterations"] == out_r[2]["iterations"] == 1


def test_lya_with_varying_temperature(tmp_path, monkeypatch):
    ref = _load("bench6", tmp_path, {}, num_packets=2048, batch_size=2048,
                max_events=8)
    T = np.asarray(ref.medium.temperature).copy()
    occ = np.asarray(ref.medium.nd)[:, 0] > 0
    T[occ] *= np.linspace(1.0, 2.0, int(occ.sum()))
    ref.medium = ref.medium._replace(temperature=jnp.asarray(T, jnp.float32))
    port = bridge.simulation(ref, "cpu", march=True)
    assert lc.check_wavelength_changing(port.medium, port.options, 0) is None
    out_r, out_p, _ = _run(monkeypatch, ref, port)
    gaps = _gaps(out_r, out_p)
    assert max(gaps.values()) <= EXACT, gaps


def test_kinematics_with_dust(tmp_path, monkeypatch):
    ref = _load("bench5", tmp_path, {
        '<ElectronMix includePolarization="true"/>':
        '<MeanFileDustMix filename="mrn_mean.txt"/>',
        'numBins="32"': 'numBins="8"'},
        num_packets=2048, batch_size=2048, max_events=6)
    assert ref.options.kinematics
    port = bridge.simulation(ref, "cpu", march=True)
    assert not lc.check_kinematics(port.medium, port.options, 0)
    out_r, out_p, _ = _run(monkeypatch, ref, port)
    gaps = _gaps(out_r, out_p)
    assert max(gaps.values()) <= EXACT, gaps


def _tree_march(name, tmp_path, edits, level=3, **run):
    """The reference loaded with its grid replaced by a density octree (or
    bench3's own tree, level None), and the port through bridge.simulation
    (march=True): no sweep tables and no leaf map on either side."""
    if level is not None:
        edits = dict(chip_smoke.tree_edits(name, level), **edits)
    ref = _load(name, tmp_path, edits, **run)
    assert type(ref.grid).__name__ == "OctreeGrid"
    assert ref._sweep_tabs is None and ref.grid.leafmap is None
    port = bridge.simulation(ref, "cpu", march=True)
    assert port._sweep_tabs is None and port.grid.leafmap is None
    return ref, port


def test_bench3_explicit_absorption_octree(tmp_path, monkeypatch):
    ref, port = _tree_march(
        "bench3", tmp_path, dict(chip_smoke.B3_SMALL, **{
            'numWavelengths="25"': 'numWavelengths="4"',
            'forceScattering="true"':
            'forceScattering="true" explicitAbsorption="true"'}),
        level=None, num_packets=2048, batch_size=2048, max_events=4)
    ref.iterate_secondary, ref.max_iterations = True, 1
    port.iterate_secondary, port.max_iterations = True, 1
    assert port.options.explicit_absorption and port.grid.ncells == 2122
    assert port.options.max_steps == min(port.grid.max_steps(), 256)
    out_r, out_p, calls = _run(monkeypatch, ref, port, dust=True)
    assert calls > 0
    gaps = _gaps(out_r, out_p)
    assert max(gaps.values()) <= EXACT, gaps
    assert out_p[2]["iterations"] == out_r[2]["iterations"] == 1
    assert out_p[2]["L_dust"] == pytest.approx(out_r[2]["L_dust"], rel=1e-5)


def test_lya_on_a_tree_with_varying_temperature(tmp_path, monkeypatch):
    ref, port = _tree_march("bench6", tmp_path, {}, num_packets=2048,
                            batch_size=2048, max_events=8)
    T = np.asarray(ref.medium.temperature).copy()
    occ = np.asarray(ref.medium.nd)[:, 0] > 0
    T[occ] *= np.linspace(1.0, 2.0, int(occ.sum()))
    ref.medium = ref.medium._replace(temperature=jnp.asarray(T, jnp.float32))
    port = bridge.simulation(ref, "cpu", march=True)
    assert lc.check_wavelength_changing(port.medium, port.options, 0) is None
    out_r, out_p, _ = _run(monkeypatch, ref, port)
    gaps = _gaps(out_r, out_p)
    assert max(gaps.values()) <= EXACT, gaps


def test_xray_on_a_tree(tmp_path, monkeypatch):
    ref, port = _tree_march("bench7", tmp_path, {}, num_packets=2048,
                            batch_size=2048, max_events=8)
    assert port.options.xray and port.xray_tabs is not None
    out_r, out_p, _ = _run(monkeypatch, ref, port)
    gaps = _gaps(out_r, out_p)
    assert max(gaps.values()) <= EXACT, gaps


def test_polarized_outflow_on_a_tree(tmp_path, monkeypatch):
    ref, port = _tree_march("bench5", tmp_path, {}, num_packets=1024,
                            batch_size=1024, max_events=6)
    assert port.options.kinematics and port.options.polarization
    out_r, out_p, _ = _run(monkeypatch, ref, port)
    as_torch = lambda acc: {k: torch.tensor(np.asarray(v))
                            for k, v in acc.items()}
    gaps = chip_smoke.b5_errors(as_torch(out_r[1][0]), out_p[1][0])
    for k, e in gaps.items():
        assert e <= chip_smoke.B5_BOUNDS.get(k, EXACT), (k, e, gaps)
