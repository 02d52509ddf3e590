"""The port's copy of the Mesh family (`skirt9_tpu_torch/grids/meshes.py`)
against the reference's `skirt9_tpu/grids/meshes.py`, bit for bit: every
builder, each ski mesh element through `from_ski` (the even and odd bin
counts of the symmetric meshes, the ratio-1 and single-bin fallbacks, the
inline and file point lists), `scale`, and the meshed Cartesian grid the
ski loader builds from them, border for border against the reference's
loader.
"""

import os
import shutil
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu.grids import meshes as ref_meshes
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.grids import meshes
from skirt9_tpu_torch.grids.cartesian import CartesianGrid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")

BUILDERS = [
    ("lin_mesh", (7,)), ("lin_mesh", (1,)),
    ("pow_mesh", (9, 10.0)), ("pow_mesh", (9, 0.05)), ("pow_mesh", (9, 1.0)),
    ("pow_mesh", (1, 5.0)),
    ("sym_pow_mesh", (16, 8.0)), ("sym_pow_mesh", (15, 8.0)),
    ("sym_pow_mesh", (12, 0.2)), ("sym_pow_mesh", (2, 8.0)),
    ("log_mesh", (10, 1e-3)), ("log_mesh", (1, 1e-3)),
    ("list_mesh", ([3.0, 1.0, 2.0, 2.0, 0.0, -1.0],)), ("list_mesh", ([],)),
]


@pytest.mark.parametrize("name,args", BUILDERS,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(BUILDERS)])
def test_builder_matches_reference(name, args):
    ours = getattr(meshes, name)(*args)
    ref = getattr(ref_meshes, name)(*args)
    assert ours.dtype == ref.dtype == np.float64
    assert np.array_equal(ours, ref)


ELEMENTS = [
    '<LinMesh numBins="5"/>',
    '<PowMesh numBins="12" ratio="20"/>',
    '<SymPowMesh numBins="16" ratio="8"/>',
    '<SymPowMesh numBins="17" ratio="8"/>',
    '<LogMesh numBins="10" centralBinFraction="0.01"/>',
    '<SymLogMesh numBins="12" centralBinFraction="0.001"/>',
    '<SymLogMesh numBins="13" centralBinFraction="0.05"/>',
    '<SymCosMesh numBins="10"/>',
    '<SymCosMesh numBins="11"/>',
    '<TabulatedMesh points="0.1, 0.3 , 0.7, 0.2"/>',
    '<ListMesh points="1 pc, 3 pc, 2 pc"/>',
    '<FileMesh filename="mesh.txt"/>',
]


@pytest.mark.parametrize("text", ELEMENTS,
                         ids=[e.split()[0][1:] + str(i)
                              for i, e in enumerate(ELEMENTS)])
def test_from_ski_matches_reference(text, tmp_path):
    np.savetxt(tmp_path / "mesh.txt", [0.5, 2.0, 1.0, 4.0])
    el = ET.fromstring(text)
    ours = meshes.from_ski(el, str(tmp_path), default_bins=32)
    ref = ref_meshes.from_ski(el, str(tmp_path), default_bins=32)
    assert np.array_equal(ours, ref)
    assert ours[0] == 0.0 and ours[-1] == 1.0
    lo, hi = -1.2 * 3.0857e16, 0.7 * 3.0857e16
    assert np.array_equal(meshes.scale(ours, lo, hi),
                          ref_meshes.scale(ref, lo, hi))


def test_from_ski_defaults_and_unknown():
    assert np.array_equal(meshes.from_ski(None, default_bins=9),
                          ref_meshes.from_ski(None, default_bins=9))
    with pytest.raises(NotImplementedError, match="NoSuchMesh"):
        meshes.from_ski(ET.fromstring('<NoSuchMesh numBins="3"/>'))


@pytest.mark.parametrize("mesh", [
    '<SymPowMesh numBins="12" ratio="8"/>',
    '<FileMesh filename="mesh.txt"/>'], ids=["sympow", "file"])
def test_loader_builds_the_reference_grid(mesh, tmp_path):
    """bench1.ski with its x mesh replaced: the port's loader builds a
    CartesianGrid with the reference's f32 borders (linear y and z), its
    volumes, diagonal, centres and max_steps."""
    np.savetxt(tmp_path / "mesh.txt", [0.5, 2.0, 1.0, 4.0])
    ski = open(os.path.join(GOLDEN, "bench1.ski")).read().replace(
        '<meshX type="Mesh"><LinMesh numBins="32"/></meshX>',
        f'<meshX type="Mesh">{mesh}</meshX>')
    (tmp_path / "m.ski").write_text(ski)
    shutil.copy(os.path.join(GOLDEN, "mrn_mean.txt"), tmp_path)
    path = str(tmp_path / "m.ski")
    ref = ref_load_ski(path, num_packets=64, batch_size=64)
    sim = load_ski(path, num_packets=64, batch_size=64, device="cpu")
    assert type(ref.grid).__name__ == "CartesianGrid"
    assert isinstance(sim.grid, CartesianGrid) and sim._sweep_tabs is None
    for a, b in zip(sim.grid, (ref.grid.xb, ref.grid.yb, ref.grid.zb)):
        assert a.dtype == torch.float32
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(sim.grid.volumes(), ref.grid.volumes())
    assert sim.grid.diagonal() == ref.grid.diagonal()
    assert sim.rf_scale == ref.rf_scale
    assert np.array_equal(sim.grid.cell_centers().numpy(),
                          np.asarray(ref.grid.cell_centers()))
    assert sim.options.max_steps == min(ref.grid.max_steps(), 256)
    assert torch.equal(sim.medium.nd,
                       torch.tensor(np.asarray(ref.medium.nd)))
