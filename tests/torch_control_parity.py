"""Fixtures shared by the control-plane parity files (``test_torch_*``):
the reference and the port run the same controller code, so what can make
their outputs differ is state outside the inputs.  ``fake_clock`` gives both
controller modules the same ``time.perf_counter`` (one millisecond per
read), which their plan searches are charged on; ``cold_sim_memo`` empties
both packages' process-wide pipesim memo, whose hit and miss counts the
decisions record, so that earlier tests in the process do not warm one side
only."""
import itertools
import types

import pytest

import repro.core.pipesim as ref_pipesim
import repro.runtime.controller as ref_controller
import repro_torch.core.pipesim as port_pipesim
import repro_torch.runtime.controller as port_controller


@pytest.fixture
def fake_clock(monkeypatch):
    for mod in (ref_controller, port_controller):
        ticks = itertools.count()
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda t=ticks: next(t) * 1e-3))


@pytest.fixture(autouse=True)
def cold_sim_memo():
    ref_pipesim.clear_sim_memo()
    port_pipesim.clear_sim_memo()
