"""A run with the timed path broken underneath comes out not correct, and
one without a fault correct, under each cell's own limits (tiny copies of
the cells on the CPU; the harness's look for a card is skipped)."""
import time

import perfutil
import pytest
import torch

from harness import cell

torch.set_num_threads(2)


def _svao_fault(change):
    """Wrap the program's SVAO pass so `change` alters its AO output."""
    from rtsdm_tpu_torch.passes.svao import SVAO
    orig = SVAO.execute

    def execute(self, ctx, inputs, state=None):
        out, ns = orig(self, ctx, inputs, state)
        return dict(out, ao=change(out["ao"])), ns
    return SVAO, "execute", execute


def _altered(monkeypatch):
    monkeypatch.setattr(*_svao_fault(lambda ao: ao * 0.9))


def _half_left_out(monkeypatch):
    def change(ao):
        ao = ao.clone()
        ao[ao.shape[0] // 2:] = 0.0
        return ao
    monkeypatch.setattr(*_svao_fault(change))


def _state_unchanged(monkeypatch):
    """renderFrame hands back its first frame's outputs from then on."""
    from rtsdm_tpu_torch.mogwai import Renderer
    orig = Renderer.renderFrame

    def render(self):
        if getattr(self, "_fault_first", None) is None:
            self._fault_first = orig(self)
        else:
            self.clock.tick()
        return self._fault_first
    monkeypatch.setattr(Renderer, "renderFrame", render)


FAULTS = {"answer_altered": _altered, "half_left_out": _half_left_out,
          "state_unchanged": _state_unchanged}
CASES = [(cell, fault) for cell in perfutil.CELLS for fault in sorted(FAULTS)]


def _run(tmp_path, name):
    root, bench = perfutil.tiny_cell(tmp_path, name)
    return cell.run(name, bench, 7, 0.2, False, time.perf_counter(),
                    device="cpu", root=root)


@pytest.mark.parametrize("name", perfutil.CELLS)
def test_sound_run_is_correct(tmp_path, name):
    assert _run(tmp_path, name)["correct"]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(tmp_path, monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    res = _run(tmp_path, name)
    assert not res["correct"]
    assert res["failed"] > 0
