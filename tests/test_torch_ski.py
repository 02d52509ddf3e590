"""The port's ski loader, units, probes and CLI against the reference's.

All on the CPU.

- Loader: for bench1, bench1h and bench2 the port's `load_ski` builds, array
  for array (`torch.equal`, `np.array_equal`), the Simulation that the
  reference's `load_ski` + `bridge.simulation` builds; its bench2 is
  `chip_smoke.config2`'s. Unknown item types, types the reference loads but
  the port does not run yet, unknown properties and modes raise
  NotImplementedError naming themselves.
- Units: `utils.units.parse` equals the reference's on every quantity string
  of the golden ski files, for every quantity whose table knows the unit;
  the cosmology and resource-lookup copies behave as the reference's.
- Probes: the temperature and radiation-field probes write the reference's
  per-cell files and cut (a radiation field drawn from a seed, on bench2).
- CLI: `python -m skirt9_tpu_torch tests/golden/bench1.ski --device cpu -p
  4096 -b 2048 -s 0` writes the SED columns and the frame cube of `python -m
  skirt9_tpu` with the same flags within 1e-5 of their maxima (they agree
  to ~3e-9); on bench2 it writes the probe files, one row per cell; on the
  reduced bench3.ski (maxLevel 4, one self-absorption iteration) it writes
  the SED, the frame and the cells, rf and T probe files equal to the API
  run's; on bench4.ski with 2,048 packets and 2 events the SED, the frame
  and the cells and T probe files of its Voronoi cells; what is not ported
  exits non-zero, and so does the default device without a GPU.
"""

import dataclasses
import os
import re
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu.probes import probes as ref_probes
from skirt9_tpu.utils import cosmology as ref_cosmology
from skirt9_tpu.utils import filepaths as ref_filepaths
from skirt9_tpu.utils import units as ref_units
from skirt9_tpu.utils.fits import read_fits
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.__main__ import main
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.probes import probes
from skirt9_tpu_torch.utils import cosmology, filepaths, units

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for these small CPU runs, so that the suite's
    parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ski(name: str) -> str:
    return os.path.join(GOLDEN, f"{name}.ski")


def _assert_same(port, ref):
    """Every array, table and option of two port Simulations, bit for bit."""
    for f in ("lo", "hi", "h", "inv_h"):
        assert torch.equal(getattr(port.grid, f), getattr(ref.grid, f)), f
    assert port.grid.shape == ref.grid.shape
    for f in ("nd", "lam_t", "sigma_ext", "sigma_sca", "g"):
        assert torch.equal(getattr(port.medium, f), getattr(ref.medium, f)), f
    for f in ("rf_borders", "ems_borders"):
        a, b = getattr(port, f), getattr(ref, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    assert len(port.sources) == len(ref.sources)
    for ps, rs in zip(port.sources, ref.sources):
        assert (ps.sed is None) == (rs.sed is None)
        if rs.sed is not None:
            assert np.array_equal(ps.sed.lam, rs.sed.lam)
            assert np.array_equal(ps.sed.s, rs.sed.s)
        assert dataclasses.replace(ps, sed=None) == \
            dataclasses.replace(rs, sed=None)
    assert port.instruments == ref.instruments
    assert port.options == ref.options
    for f in ("num_packets", "batch_size", "seed", "source_bias",
              "refill_events", "spatial_bias", "iterate_secondary",
              "min_iterations", "max_iterations", "max_fraction_of_primary",
              "max_fraction_of_previous", "secondary_packets_multiplier",
              "dust_emission_type", "cmb_temperature", "rf_scale"):
        assert getattr(port, f) == getattr(ref, f), f


@pytest.mark.parametrize("name", ["bench1", "bench1h", "bench2"])
def test_load_ski_matches_reference(name):
    kw = dict(num_packets=1 << 14, batch_size=4096, seed=3, max_events=16)
    ref_sim = ref_load_ski(_ski(name), **kw)
    port = load_ski(_ski(name), device="cpu", **kw)
    _assert_same(port, bridge.simulation(ref_sim, "cpu"))
    assert dataclasses.asdict(port.units) == dataclasses.asdict(ref_sim.units)
    assert type(port.cosmology).__name__ == type(ref_sim.cosmology).__name__
    assert [(p.kind, p.name, p.when) for p in port.probes] == \
        [(p.kind, p.name, p.when) for p in ref_sim.probes]
    assert port.grid.shape == (32, 32, 32)
    # oligochromatic bench1 and bench1h at 0.55 micron, bench2 panchromatic
    assert (port.sources[0].sed is None) == (name != "bench2")


@pytest.mark.parametrize("axis", ["X", "Y"])
def test_optical_depth_axis_matches_reference(tmp_path, axis):
    """OpticalDepthMaterialNormalization along another axis (the shell is
    symmetric, so the densities agree with the z axis's too)."""
    path = _edited(tmp_path, "bench1", 'axis="Z"', f'axis="{axis}"')
    kw = dict(num_packets=1 << 12, batch_size=1 << 12)
    port = load_ski(path, device="cpu", **kw)
    _assert_same(port, bridge.simulation(ref_load_ski(path, **kw), "cpu"))
    assert torch.equal(port.medium.nd,
                       load_ski(_ski("bench1"), device="cpu", **kw).medium.nd)


def test_bench2_is_chip_smoke_config2():
    port = load_ski(_ski("bench2"), num_packets=1 << 20, batch_size=1 << 17,
                    max_events=24, device="cpu")
    _assert_same(port, chip_smoke.config2("cpu"))
    assert len(port.probes) == 2


def _edited(tmp_path, name: str, old: str, new: str) -> str:
    text = open(_ski(name)).read()
    assert old in text
    path = tmp_path / f"{name}_edited.ski"
    path.write_text(text.replace(old, new))
    return str(path)


@pytest.mark.parametrize("old,new,named", [
    # a type nobody knows
    ("ShellGeometry", "NoSuchGeometry", "NoSuchGeometry"),
    # types the reference loads but the port does not run yet
    ("CartesianSpatialGrid", "Sphere2DSpatialGrid", "Sphere2DSpatialGrid"),
    ('BlackBodySED temperature="5778 K"', 'QuasarSED', "QuasarSED"),
    ("TrivialGasMix", "MeanInterstellarDustMix", "MeanInterstellarDustMix"),
    # a property outside the port's items
    ("<probeSystem", '<wavelengthBiasDistribution '
     'type="WavelengthDistribution"/><probeSystem',
     "wavelengthBiasDistribution"),
    ('simulationMode="OligoExtinctionOnly"', 'simulationMode="GasEmission"',
     "GasEmission"),
])
def test_unported_items_raise(tmp_path, old, new, named):
    path = _edited(tmp_path, "bench1", old, new)
    if named == "Sphere2DSpatialGrid":
        # ported since: bench1's medium on a 2D sphere of 24 x 16 cells,
        # held to the reference's loader array for array
        text = open(_ski("bench1")).read()
        grid = text[text.index("<CartesianSpatialGrid"):
                    text.index("</CartesianSpatialGrid>")
                    + len("</CartesianSpatialGrid>")]
        open(path, "w").write(text.replace(grid, (
            '<Sphere2DSpatialGrid maxRadius="1.2 pc"><meshRadial type="Mesh">'
            '<LinMesh numBins="24"/></meshRadial><meshPolar type="Mesh">'
            '<LinMesh numBins="16"/></meshPolar></Sphere2DSpatialGrid>')))
        kw = dict(num_packets=1024, batch_size=1024, max_events=4)
        conv = bridge.simulation(ref_load_ski(path, **kw), "cpu")
        port = load_ski(path, device="cpu", **kw)
        assert type(port.grid).__name__ == named.replace("SpatialGrid",
                                                         "Grid")
        for a, b in zip(port.grid, conv.grid):
            assert torch.equal(a, b) if torch.is_tensor(a) else a == b
        assert torch.equal(port.medium.nd, conv.medium.nd)
        assert port.options == conv.options
        assert port.instruments == conv.instruments
        return
    if named == "MeanInterstellarDustMix":
        # ported since: the reference's analytic mean interstellar curve,
        # held to its loader array for array
        kw = dict(num_packets=1024, batch_size=1024, max_events=4)
        conv = bridge.simulation(ref_load_ski(path, **kw), "cpu")
        _assert_same(load_ski(path, device="cpu", **kw), conv)
        return
    with pytest.raises(NotImplementedError, match=named):
        load_ski(path, device="cpu")


def _golden_quantities():
    """Every attribute value of the golden ski files that reads as a number
    with a unit."""
    texts = set()
    for fn in sorted(os.listdir(GOLDEN)):
        if fn.endswith(".ski"):
            for el in ET.parse(os.path.join(GOLDEN, fn)).getroot().iter():
                texts.update(v for v in el.attrib.values()
                             if re.match(r"^\s*[-+0-9.]", v))
    return sorted(texts)


def test_units_parse_matches_reference():
    texts = _golden_quantities()
    assert {"1e5 Lsun", "0.55 micron", "1.2 pc", "-1.2 pc", "100 pc",
            "5778 K", "4e-25 m2", "0 km/s", "0 deg"} <= set(texts)
    compared = 0
    for text in texts:
        for qty in ref_units._UNITS:
            try:
                want = ref_units.parse(qty, text)
            except ValueError:
                with pytest.raises(ValueError):
                    units.parse(qty, text)
                continue
            got = units.parse(qty, text)
            assert got == want and type(got) is type(want), (qty, text)
            compared += 1
    assert compared > 200
    for qty, text in (("wavelength", "0.55 micron, 1 micron"),
                      ("bolluminosity", "1 Lsun,2e14 W")):
        assert units.parse_list(qty, text) == ref_units.parse_list(qty, text)
    for qty, value in (("length", 1.2 * 3.0857e16), ("wavelength", 5.5e-7)):
        assert units.format_si(qty, value) == ref_units.format_si(qty, value)


def test_cosmology_and_resources_match_reference():
    for xml in ("<LocalUniverseCosmology/>",
                '<FlatUniverseCosmology redshift="0.5"/>'):
        el = ET.fromstring(xml)
        got, want = cosmology.from_ski(el), ref_cosmology.from_ski(el)
        assert got.redshift == want.redshift
        assert got.luminosity_distance() == want.luminosity_distance()
    assert filepaths.has_resource("NoSuchTable.stab") is False
    with pytest.raises(FileNotFoundError, match="NoSuchTable"):
        filepaths.find_resource("NoSuchTable.stab")
    with pytest.raises(FileNotFoundError, match="NoSuchTable"):
        ref_filepaths.find_resource("NoSuchTable.stab")


def test_redshift_raises(tmp_path):
    path = _edited(tmp_path, "bench1", "<LocalUniverseCosmology/>",
                   '<FlatUniverseCosmology redshift="0.1"/>')
    with pytest.raises(NotImplementedError, match="redshift"):
        load_ski(path, device="cpu")


def test_probes_match_reference(tmp_path):
    """bench2's two probes on a radiation field drawn from a seed: the same
    cell centers, temperatures and mean intensities as the reference's
    probes (the equilibrium temperature within 1e-6 relative), and the same
    temperature cut."""
    kw = dict(num_packets=1 << 14, batch_size=4096)
    ref_sim = ref_load_ski(_ski("bench2"), **kw)
    port = load_ski(_ski("bench2"), device="cpu", **kw)
    rs = np.random.default_rng(7)
    rf = (10.0 ** rs.uniform(-3, 1, (port.grid.ncells, 25))).astype(
        np.float32)
    out_r, out_p = tmp_path / "ref", tmp_path / "port"
    out_r.mkdir()
    out_p.mkdir()
    paths_r = ref_probes.run_probe_system(ref_sim, "Run", "b2", str(out_r),
                                          rf=rf)
    paths_p = probes.run_probe_system(port, "Run", "b2", str(out_p),
                                      rf=torch.tensor(rf))
    assert [os.path.basename(p) for p in paths_p] == \
        [os.path.basename(p) for p in paths_r] == [
            "b2_rf_radiationfield.dat", "b2_T_temperature.dat",
            "b2_T_temperature_z.fits"]
    assert probes.run_probe_system(port, "Setup", "b2", str(out_p),
                                   rf=torch.tensor(rf)) == []
    J_r, J_p = (np.loadtxt(p[0]) for p in (paths_r, paths_p))
    assert J_p.shape == (32 ** 3, 3 + 25)
    assert np.array_equal(J_p, J_r)
    T_r, T_p = (np.loadtxt(p[1]) for p in (paths_r, paths_p))
    assert np.array_equal(T_p[:, :3], T_r[:, :3])
    np.testing.assert_allclose(T_p[:, 3], T_r[:, 3], rtol=1e-6)
    assert np.array_equal(T_p[:, 3], port.dust_temperature(
        torch.tensor(rf))[:, 0])
    cut_r, _ = read_fits(paths_r[2])
    cut_p, _ = read_fits(paths_p[2])
    assert cut_p.shape == cut_r.shape == (256, 256)
    np.testing.assert_allclose(cut_p, cut_r, rtol=1e-6)


def test_cli_matches_reference(tmp_path):
    # one thread each, so that the suite's parallel workers do not
    # oversubscribe the cores
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    flags = ["-p", "4096", "-b", "2048", "-s", "0"]
    for pkg, extra in (("skirt9_tpu", []),
                       ("skirt9_tpu_torch", ["--device", "cpu"])):
        res = subprocess.run(
            [sys.executable, "-m", pkg, "tests/golden/bench1.ski", *extra,
             *flags, "-o", str(tmp_path / pkg)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
    ref = np.loadtxt(tmp_path / "skirt9_tpu" / "bench1_i0_sed.dat")
    ours = np.loadtxt(tmp_path / "skirt9_tpu_torch" / "bench1_i0_sed.dat")
    assert ours.shape == ref.shape == (9,)
    assert ref[2] > 0 and ref[3] > 0 and ref[4] > 0
    assert np.all(np.abs(ours - ref) <= 1e-5 * np.abs(ref))
    cube_r, _ = read_fits(str(tmp_path / "skirt9_tpu"
                              / "bench1_i0_total.fits"))
    cube, _ = read_fits(str(tmp_path / "skirt9_tpu_torch"
                            / "bench1_i0_total.fits"))
    assert cube.shape == cube_r.shape == (1, 64, 64)
    assert np.abs(cube - cube_r).max() <= 1e-5 * np.abs(cube_r).max()


def test_cli_writes_probes(tmp_path):
    assert main([_ski("bench2"), "--device", "cpu", "-p", "2048", "-b",
                 "1024", "-o", str(tmp_path)]) == 0
    names = sorted(os.listdir(tmp_path))
    assert names == ["bench2_T_temperature.dat", "bench2_T_temperature_z.fits",
                     "bench2_i0_sed.dat", "bench2_i0_total.fits",
                     "bench2_log.txt", "bench2_rf_radiationfield.dat"]
    T = np.loadtxt(tmp_path / "bench2_T_temperature.dat")
    J = np.loadtxt(tmp_path / "bench2_rf_radiationfield.dat")
    assert T.shape == (32 ** 3, 4) and J.shape == (32 ** 3, 3 + 25)
    assert np.isfinite(T).all() and np.isfinite(J).all() and J.max() > 0
    lit = T[:, 3] > 0
    assert 10 < np.median(T[lit, 3]) < 200
    sed = np.loadtxt(tmp_path / "bench2_i0_sed.dat")
    assert sed.shape == (40, 9) and sed[:, 5].max() > 0   # secondary flux


def test_cli_on_reduced_bench3(tmp_path):
    """The CLI on the reduced bench3.ski (one self-absorption iteration at
    most, to keep the CLI's 64 events a batch short) writes the SED, the
    frame and the three probe files, equal to the outputs of the API run
    at the same settings."""
    path = chip_smoke.edited_ski("bench3", tmp_path, dict(
        chip_smoke.B3_SMALL, **{'maxSecondaryIterations="10"':
                                'maxSecondaryIterations="1"'}))
    out = tmp_path / "cli"
    assert main([path, "--device", "cpu", "-p", "8192", "-b", "4096",
                 "-o", str(out)]) == 0
    names = sorted(os.listdir(out))
    assert names == ["small_T_temperature.dat", "small_T_temperature_z.fits",
                     "small_cells_cellprops.dat", "small_i0_sed.dat",
                     "small_i0_total.fits", "small_log.txt",
                     "small_rf_radiationfield.dat"]
    api = load_ski(path, num_packets=8192, batch_size=4096, device="cpu")
    rf, accs, info = api.run_with_dust_emission(verbose=False)
    assert info["iterations"] == 1 and info["L_dust"] > 0
    api_dir = tmp_path / "api"
    api_dir.mkdir()
    api.write_outputs(accs, "small", str(api_dir))
    probes.run_probe_system(api, "Setup", "small", str(api_dir))
    probes.run_probe_system(api, "Run", "small", str(api_dir), rf=rf)
    for name in names:
        if name.endswith(".dat"):
            assert np.array_equal(np.loadtxt(out / name),
                                  np.loadtxt(api_dir / name)), name
        elif name.endswith(".fits"):
            a, _ = read_fits(str(out / name))
            b, _ = read_fits(str(api_dir / name))
            assert np.array_equal(a, b) and b.max() > 0, name
    sed = np.loadtxt(out / "small_i0_sed.dat")
    assert sed.shape == (40, 9) and sed[:, 5].max() > 0   # secondary flux
    J = np.loadtxt(out / "small_rf_radiationfield.dat")
    assert J.shape == (api.grid.ncells, 3 + 25) and J[:, 3:].max() > 0


def test_cli_on_reduced_bench4(tmp_path):
    """The CLI on bench4.ski with its packets cut to 2,048 (one stratified
    batch of 32,768 lanes a segment) and 2 events a packet writes the SED,
    the frame, the cells probe (the Voronoi sites, their exact volumes and
    densities) and the temperature probe, one row per cell."""
    path = chip_smoke.edited_ski("bench4", tmp_path, {
        'numPackets="1e6"': 'numPackets="2048"'})
    out = tmp_path / "cli"
    assert main([path, "--device", "cpu", "-b", "4096", "--max-events", "2",
                 "-o", str(out)]) == 0
    assert sorted(os.listdir(out)) == [
        "small_T_temperature.dat", "small_T_temperature_z.fits",
        "small_cells_cellprops.dat", "small_i0_sed.dat",
        "small_i0_total.fits", "small_log.txt"]
    sed = np.loadtxt(out / "small_i0_sed.dat")
    assert sed.shape == (40, 9) and np.isfinite(sed).all()
    assert sed[:, 2].max() > 0 and sed[:, 5].max() > 0   # secondary flux
    cube, _ = read_fits(str(out / "small_i0_total.fits"))
    assert cube.shape == (40, 64, 64) and np.isfinite(cube).all()
    sim = load_ski(path, device="cpu")
    cells = np.loadtxt(out / "small_cells_cellprops.dat")
    assert cells.shape == (2895, 5)
    assert np.array_equal(cells[:, :3], sim.grid.sites.double().numpy())
    assert np.array_equal(cells[:, 3], sim.grid.volumes())
    assert np.array_equal(cells[:, 4], sim.medium.nd[:, 0].double().numpy())
    T = np.loadtxt(out / "small_T_temperature.dat")
    assert T.shape == (2895, 4) and np.isfinite(T).all()
    assert 5 < np.median(T[T[:, 3] > 0, 3]) < 200


@pytest.mark.parametrize("argv,named", [
    (["-d", "2", "--dd"], "-d/--dd"), (["--dd"], "-d/--dd"),
    (["--export-schema", "schema.xml"], "--export-schema"),
    ([], "wizard")])
def test_cli_refuses_what_is_not_ported(argv, named, tmp_path, capsys):
    ski = [] if named == "wizard" else [_ski("bench1")]
    assert main(ski + argv + ["--device", "cpu", "-o", str(tmp_path)]) == 2
    assert named in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


def test_cli_default_device_needs_cuda(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([_ski("bench1"), "-o", str(tmp_path / "out")]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "out")
