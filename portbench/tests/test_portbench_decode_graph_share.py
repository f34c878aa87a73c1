import sys
import types

import pytest

from portbench import spec


def _program(monkeypatch, calls):
    """A stand-in ``repro_torch.models.model`` whose ``Model`` counts
    ``calls`` (None: a program without the counter)."""
    mod = types.ModuleType("repro_torch.models.model")
    mod.Model = type("Model", (), {} if calls is None
                     else {"decode_calls": calls})
    monkeypatch.setitem(sys.modules, "repro_torch.models.model", mod)


@pytest.mark.parametrize("calls, share", [
    ({"eager": 1, "captured": 1, "replayed": 98}, 98.0),
    ({"eager": 5, "captured": 0, "replayed": 0}, 0.0),
    ({"eager": 0, "captured": 1, "replayed": 3}, 75.0)])
def test_reads_the_replayed_share(monkeypatch, calls, share):
    _program(monkeypatch, calls)
    assert spec.reader("model.decode_graph_share")({}) == pytest.approx(share)


@pytest.mark.parametrize("calls", [
    None, {}, {"eager": 0, "captured": 0, "replayed": 0}])
def test_nothing_where_the_program_counts_none(monkeypatch, calls):
    _program(monkeypatch, calls)
    assert spec.reader("model.decode_graph_share")({}) is None


def test_nothing_without_the_program(monkeypatch):
    monkeypatch.delitem(sys.modules, "repro_torch.models.model",
                        raising=False)
    assert spec.reader("model.decode_graph_share")({}) is None


def test_the_hostpaced_name_reads_the_same_file(monkeypatch):
    _program(monkeypatch, {"eager": 1, "captured": 1, "replayed": 2})
    assert spec.reader("model.decode_graph_share.hostpaced")({}) == 50.0
    bench = spec.load_benchmark()
    names = {m["name"]: m for m in bench["per_layer"]}
    assert names["model.decode_graph_share"]["moves"] == "output_tok_s"
    assert names["model.decode_graph_share.hostpaced"]["moves"] == \
        "output_tok_s.hostpaced"
