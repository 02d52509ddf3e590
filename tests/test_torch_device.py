"""Entry points run on the card unless the caller asks for the CPU.

`device.resolve(None)` means CUDA: where `torch.cuda.is_available()` is
False it raises, and it never returns a CPU device by itself; naming the
CPU works everywhere. `Simulation` and the probe tools default to CUDA.
"""

import numpy as np
import pytest
import torch

from skirt9_tpu_torch import device as dv
from skirt9_tpu_torch.grids.cartesian import make_cartesian
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.simulation import Simulation
from skirt9_tpu_torch.sources.base import PointSource
from skirt9_tpu_torch.tools import gather_probe, sublane_gather
from skirt9_tpu_torch.transport.lifecycle import TransportOptions


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", [None, "cuda", "cuda:0",
                                  torch.device("cuda")])
def test_cuda_without_gpu_raises(no_gpu, name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dv.resolve(name)


@pytest.mark.parametrize("name", ["cpu", torch.device("cpu")])
def test_cpu_on_request(no_gpu, name):
    assert dv.resolve(name) == torch.device("cpu")


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        dv.resolve("meta")


def test_default_is_cuda_when_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert dv.resolve(None).type == "cuda"


def _sim(**kw):
    grid = make_cartesian(((-1.0, 1.0),) * 3, (4,) * 3)
    med = msys.make_medium(grid, np.ones(grid.ncells, np.float32),
                           np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), 0.1),
                           albedo=np.full((1, 2), 0.5), g=np.full((1, 2), 0.0))
    return Simulation(grid=grid, medium=med, sources=[PointSource()],
                      instruments=[],
                      options=TransportOptions(max_steps=grid.max_steps()),
                      **kw)


def test_entry_points_default_to_the_card(no_gpu):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _sim()
    assert _sim(device="cpu").device == torch.device("cpu")
    for tool in (gather_probe, sublane_gather):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main([])
