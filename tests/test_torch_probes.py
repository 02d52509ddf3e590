"""The gather and row-lookup probes (TPU kernels 8-9) on the CPU.

The plain PyTorch versions beside the CUDA kernels are held against the TPU
kernels' own semantics, on inputs from numpy seeds:
- kernel 9 (`tools/bench_sublane_gather.py`): `kern_gather` and
  `kern_select` run through `pl.pallas_call(..., interpret=True)` at small
  shapes (R, S, ITERS set with monkeypatch, which edits no file); the plain
  chain, its select form and the one-gather library form agree within 1e-6
  relative (the same f32 sums; the library form adds in another order);
- kernel 8 (`tools/_pallas_probe.py` runs Pallas when imported, so it is
  not imported): the kernel bodies' jnp expressions `nd[idx]`,
  `jnp.take(nd, idx, axis=0)` and `zeros.at[idx].add(vals)`, against which
  the gathers are bit-exact and the scatter-add within 1e-6 relative.
On the CPU every wrapper takes its plain version and launches nothing; the
entry points run at the original shapes with `--device cpu`.

The kernels' own rules are held here too: the row lookup's floor-mod start
rows (below 0 and at or past R) against a numpy reference, the plain
gather and scatter at a table size that is no multiple of the kernels'
pieces (4,099 entries), the wrappers' 16-byte alignment of what the kernels
load four at a time, and a refused launch raising.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.tools import gather_probe as gp
from skirt9_tpu_torch.tools import sublane_gather as sg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def sublane_module(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "bench_sublane_gather", os.path.join(REPO, "tools",
                                             "bench_sublane_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "R", 16)
    monkeypatch.setattr(mod, "S", 8)
    monkeypatch.setattr(mod, "ITERS", 12)
    return mod


@pytest.mark.parametrize("kern,select", [("kern_gather", False),
                                         ("kern_select", True)])
def test_row_lookup_plain_vs_pallas(sublane_module, kern, select):
    m = sublane_module
    tab, idx = sg.inputs("cpu", r=m.R, s=m.S)
    f = pl.pallas_call(getattr(m, kern), interpret=True,
                       out_shape=jax.ShapeDtypeStruct((m.S, 128), jnp.float32))
    ref = np.asarray(f(jnp.asarray(tab.numpy()), jnp.asarray(idx.numpy())))
    kb.reset_launches()
    got = sg.lookup(tab, idx, iters=m.ITERS, select=select).numpy()
    lib = sg.lookup_library(tab, idx, iters=m.ITERS).numpy()
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    for out in (got, lib):
        assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
    assert np.array_equal(got, sg.lookup_plain(tab, idx, m.ITERS,
                                               select=not select).numpy())


@pytest.mark.parametrize("contract", ["gather_kernel", "take_kernel"])
def test_gather_plain_vs_kernel_bodies(contract):
    nd, idx, _ = gp.inputs("cpu", n=4096, b=20000)
    jnd, jidx = jnp.asarray(nd.numpy()), jnp.asarray(idx.numpy())
    ref = jnd[jidx] if contract == "gather_kernel" else jnp.take(jnd, jidx,
                                                                  axis=0)
    fn = gp.gather if contract == "gather_kernel" else gp.take
    for out in (fn(nd, idx), gp.gather(nd, idx, staged=False),
                gp.gather_plain(nd, idx)):
        assert np.array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("unit", [True, False])
def test_scatter_plain_vs_kernel_body(unit):
    nd, idx, ones = gp.inputs("cpu", n=4096, b=20000)
    vals = ones if unit else torch.tensor(
        np.random.default_rng(2).uniform(0, 1, 20000).astype(np.float32))
    ref = np.asarray(jnp.zeros(4096, jnp.float32).at[
        jnp.asarray(idx.numpy())].add(jnp.asarray(vals.numpy())))
    for out in (gp.scatter(idx, vals, 4096),
                gp.scatter_plain(idx, vals, 4096)):
        assert np.abs(out.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    if unit:      # the probe's own check: a bincount
        assert np.array_equal(gp.scatter(idx, vals, 4096).numpy(),
                              np.bincount(idx.numpy(), minlength=4096))


def test_probe_inputs_are_the_original_seeds():
    nd, idx, vals = gp.inputs("cpu")
    assert nd.shape == (32768,) and idx.shape == vals.shape == (131072,)
    assert np.array_equal(nd.numpy(), np.random.default_rng(0).uniform(
        1, 2, 32768).astype(np.float32))
    assert np.array_equal(idx.numpy(), np.random.default_rng(1).integers(
        0, 32768, 131072).astype(np.int32))
    tab, ix = sg.inputs("cpu")
    assert tab.shape == (512, 128) and ix.shape == (64, 128)


def test_gather_probe_entry_point_on_cpu(capsys):
    kb.reset_launches()
    assert gp.main(["--device", "cpu", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 6 and all("correct=True" in ln for ln in lines[:5])
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrappers_reject_what_kernels_do_not_take(bad):
    nd, idx, vals = gp.inputs("cpu", n=64, b=100)
    tab, ix = sg.inputs("cpu", r=16, s=2)
    with pytest.raises(ValueError):
        if bad == "dtype":
            gp.gather(nd, idx.long())
        else:
            gp.scatter(idx, vals[:50], 64)
    with pytest.raises(ValueError):
        if bad == "dtype":
            sg.lookup(tab.double(), ix)
        else:
            sg.lookup(tab, ix[:, :64])


@pytest.mark.parametrize("R,S,W,iters", [(16, 8, 128, 40), (500, 5, 37, 300)],
                         ids=["small", "off-grid"])
def test_lookup_plain_floor_mod_start_rows(R, S, W, iters):
    """Start rows below 0 and at or past R wrap by floor-mod, and the chain
    adds in step order from 0: numpy's f32 adds in the same order give the
    same bits; the one-gather library form agrees within 1e-6 relative."""
    tab, idx = sg.inputs("cpu", R, S, W)
    idx = idx * 5 - 2 * R
    ix = idx.numpy().astype(np.int64)
    assert (ix < 0).any() and (ix >= R).any()
    t = tab.numpy()
    ref = np.zeros((S, W), np.float32)
    for i in range(iters):
        ref = ref + np.take_along_axis(t, np.mod(ix + i, R), axis=0)
    got = sg.lookup_plain(tab, idx, iters).numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(sg.lookup(tab, idx, iters).numpy(), ref)
    lib = sg.lookup_library(tab, idx, iters).numpy()
    assert np.abs(lib - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("contract", ["gather_kernel", "take_kernel"])
def test_gather_plain_ragged_vs_kernel_bodies(contract):
    """At 4,099 entries, no multiple of the 16-byte staging loads."""
    nd, idx, _ = gp.inputs("cpu", n=4099, b=20001)
    jnd, jidx = jnp.asarray(nd.numpy()), jnp.asarray(idx.numpy())
    ref = jnd[jidx] if contract == "gather_kernel" else jnp.take(jnd, jidx,
                                                                  axis=0)
    fn = gp.gather if contract == "gather_kernel" else gp.take
    for out in (fn(nd, idx), gp.gather(nd, idx, staged=False),
                gp.gather_plain(nd, idx)):
        assert np.array_equal(out.numpy(), np.asarray(ref))


def test_scatter_plain_ragged_vs_kernel_body():
    _, idx, _ = gp.inputs("cpu", n=4099, b=20001)
    vals = torch.tensor(np.random.default_rng(2).uniform(0, 1, 20001)
                        .astype(np.float32))
    ref = np.asarray(jnp.zeros(4099, jnp.float32).at[
        jnp.asarray(idx.numpy())].add(jnp.asarray(vals.numpy())))
    for out in (gp.scatter(idx, vals, 4099),
                gp.scatter_plain(idx, vals, 4099)):
        assert np.abs(out.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_wrappers_align_what_kernels_load_in_16_bytes(offset):
    """The table, the indices and the values reach the kernels contiguous
    and on 16 bytes (a view that starts elsewhere is copied), with their
    values unchanged."""
    base = torch.arange(64, dtype=torch.float32)
    view = base[offset:offset + 40]
    got = gp._aligned(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert torch.equal(got, view)
    assert (got.data_ptr() == view.data_ptr()) == (view.data_ptr() % 16 == 0)
    strided = base[::2]
    assert torch.equal(gp._aligned(strided), strided)
    assert gp._aligned(strided).is_contiguous()


def test_refused_launch_raises(monkeypatch):
    """A nonzero cudaError from a C entry (a launch the card refuses, say)
    raises, and the launch is not counted."""
    class Refusing:
        def probe_gather_launch(self, *args):
            return 801                  # cudaErrorNotSupported
    monkeypatch.setattr(kb, "_lib", Refusing())
    kb.reset_launches()
    with pytest.raises(RuntimeError, match="probe_gather_smem"):
        kb.launch("probe_gather", 0, 0, 0, 4, 4, 1, 0,
                  count_as="probe_gather_smem")
    assert kb.LAUNCHES["probe_gather_smem"] == 0
