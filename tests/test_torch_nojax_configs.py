"""The port imports neither jax nor any module of the JAX package, and
launches no kernel on the CPU: the bench configurations (`nojax_runner`).

- config3: the reduced config 3 (bench3.ski at maxLevel 4 with a 4-bin RF
  through the loader, with and without merged iterations);
- cli: the CLI on bench1.ski, and bench2.ski's set-up with its probes;
- configs5_7: a reduced bench5.ski (polarized Thomson scattering in a
  moving electron disk) with its Stokes outputs, and bench6.ski
  (Lyman-alpha) and bench7.ski (X-ray gas) through the loader and the CLI.
"""

import pytest

import nojax_runner

GROUPS = {
    "config3": """
with tempfile.TemporaryDirectory() as tmp:
    path = chip_smoke.edited_ski("bench3", tmp, dict(
        chip_smoke.B3_SMALL, **{'numWavelengths="25"': 'numWavelengths="4"'}))
    for merged in (False, True):
        sim = chip_smoke.config3("cpu", num_packets=1024, batch_size=1024,
                                 max_events=2, path=path)
        sim.max_iterations, sim.include_primary = 1, merged
        rf, accs, info = sim.run_with_dust_emission(verbose=False)
        assert rf.shape == (2122, 4) and float(rf.sum()) > 0
        assert info["iterations"] == 1 and info["L_dust"] > 0
        assert float(accs[0]["sed"][3].sum()) > 0
""",
    "cli": """
with tempfile.TemporaryDirectory() as tmp:
    assert main(["tests/golden/bench1.ski", "--device", "cpu", "-p", "256",
                 "-b", "128", "-o", tmp]) == 0
    assert main(["tests/golden/bench2.ski", "--device", "cpu", "-e",
                 "-o", tmp]) == 0
    assert sorted(os.listdir(tmp)) == ["bench1_i0_sed.dat",
                                       "bench1_i0_total.fits",
                                       "bench1_log.txt", "bench2_log.txt"]
""",
    "configs5_7": """
with tempfile.TemporaryDirectory() as tmp:
    path = chip_smoke.edited_ski("bench5", tmp, {'numBins="32"':
                                                 'numBins="8"'})
    sim = load_ski(path, num_packets=256, batch_size=128, max_events=2,
                   device="cpu")
    assert sim.options.kinematics and sim.options.polarization
    rf, accs = sim.run_primary(verbose=False)
    assert float(accs[0]["stokes"].abs().sum()) > 0
    assert len(sim.write_outputs(accs, "b5", tmp)) == 5
with tempfile.TemporaryDirectory() as tmp:
    for name in ("bench6", "bench7"):
        sim = load_ski(f"tests/golden/{name}.ski", num_packets=256,
                       batch_size=128, max_events=3, device="cpu")
        assert sim.options.lya == (name == "bench6")
        assert sim.options.xray == (name == "bench7")
        rf, accs = sim.run_primary(verbose=False)
        assert float(accs[0]["sed"][2].sum()) > 0
        assert main([f"tests/golden/{name}.ski", "--device", "cpu", "-p",
                     "256", "-b", "128", "-o", tmp]) == 0
    assert sorted(os.listdir(tmp)) == ["bench6_i0_sed.dat", "bench6_log.txt",
                                       "bench7_i0_sed.dat", "bench7_log.txt"]
""",
}


@pytest.mark.parametrize("group", list(GROUPS))
def test_port_never_imports_jax(group):
    nojax_runner.run(GROUPS[group])
