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
