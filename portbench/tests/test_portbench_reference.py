"""The plain reference against the port at smoke width, on the CPU."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from portbench import check, serve, weights  # noqa: E402
from portbench.reference import moe as ref_moe  # noqa: E402
from portbench.tests import smoke  # noqa: E402

CONFIGS = ["nemotron-4-340b-l4", "deepseek-moe-16b"]


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_are_laid_out_as_the_ports(name):
    from repro_torch.models.model import abstract_params
    from portbench import spec
    cfg, dm = serve.port_config(spec.config(spec.load_benchmark(), name))
    want, _ = abstract_params(cfg)

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = tuple(v[0] if isinstance(v, tuple)
                                        and isinstance(v[0], tuple)
                                        else v.shape)
        return out
    assert shapes(weights.layout(dm)) == shapes(want)


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_come_from_the_seed(name):
    dm = weights.dims(smoke.config(name))
    a = weights.make(dm, 2**31 + 3, "cpu")
    b = weights.make(dm, 2**31 + 3, "cpu")
    c = weights.make(dm, 5, "cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["final_norm"]["scale"],
                       torch.ones_like(a["final_norm"]["scale"]))


def _served(model, prompt, new_tokens, max_len=64):
    """Greedy tokens of the port: a prefill, then decode steps through
    its cache, and the logits of each."""
    cache = model.init_cache(1, max_len)
    toks = torch.tensor([prompt])
    logits, pre, idx = model.prefill(toks, max_len)
    for key in cache:
        def put(full, one):
            if isinstance(full, dict):
                for k in full:
                    put(full[k], one[k])
            else:
                full.copy_(one)
        put(cache[key], pre[key])
    out, all_logits = [], [logits[0, -1].float()]
    for _ in range(new_tokens):
        nxt = int(all_logits[-1].argmax())
        out.append(nxt)
        logits, cache = model.decode_step(
            cache, torch.tensor([[nxt]]), torch.tensor([idx]),
            max_len=max_len)
        idx += 1
        all_logits.append(logits[0, -1].float())
    return out, torch.stack(all_logits[:-1])


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_agrees_with_the_port(name):
    from repro_torch.models.model import Model
    spec_ = smoke.config(name)
    cfg, dm = serve.port_config(spec_)
    params = weights.make(dm, 11, "cpu")
    model = Model(cfg, params=params, device="cpu")
    gen = torch.Generator().manual_seed(0)
    seqs, port = [], []
    for plen in (9, 24):
        prompt = torch.randint(1, dm["vocab"], (plen,), generator=gen)
        served, logits = _served(model, prompt.tolist(), 6)
        seqs.append(dict(prompt=prompt.tolist(), served=served))
        port.append(logits)
    mod = check.importlib.import_module(
        f"portbench.reference.{spec_['family']}")
    with torch.no_grad():
        ref = mod.logits(params, spec_, mod.hidden(params, spec_, seqs,
                                                   False), False)
    port = torch.cat(port)
    scale = ref.abs().max()
    err = (port - ref).abs().max(dim=1).values
    if spec_["family"] == "moe":
        # bf16 against float32 over a few layers at width 64 differs by a
        # few per cent of the largest logit; a routing decision near a tie can go the other way in float32
        # than in bf16, and move that position's logits by a whole
        # expert's output: all but one position agree
        assert int((err > 0.05 * scale).sum()) <= 1
    else:
        assert err.max() <= 0.05 * scale
    got = check.gaps(params, spec_, seqs, control=True)
    assert got["positions"] == 12
    assert got["logit_gap"] <= 0.05 * float(scale)
    assert got["control_logit_gap"] >= 0


def test_reference_drops_what_a_prefill_drops():
    """A prompt whose assignments overflow an expert's capacity: the
    reference keeps the first ``capacity`` of them in token-major order,
    as the port's prefill does."""
    from repro_torch.models.layers import moe_dispatch
    idx = torch.tensor([[0, 1], [0, 2], [0, 1], [3, 0]])
    keep = ref_moe.kept(idx, 4, 2)
    _, _, port_keep = moe_dispatch(idx, 4, 2)
    assert torch.equal(keep.reshape(-1), port_keep)
    assert keep.tolist() == [[True, True], [True, True], [False, True],
                             [True, False]]


def test_port_config_refuses_a_mismatch():
    spec_ = smoke.config("nemotron-4-340b-l4")
    spec_ = dict(spec_, port=dict(spec_["port"], overrides=dict(
        spec_["port"]["overrides"], d_ff=64)))
    with pytest.raises(ValueError, match="d_ff"):
        serve.port_config(spec_)
    assert dataclasses.is_dataclass(serve.port_config(
        smoke.config("nemotron-4-340b-l4"))[0])


def test_reference_runs_the_published_routing_on_request():
    """``as_published`` (gates as the softmax gave them, nothing dropped)
    reads other logits than the port's stated routing; each switch
    alone moves them."""
    spec_ = smoke.config("deepseek-moe-16b")
    dm = weights.dims(spec_)
    params = weights.make(dm, 13, "cpu")
    gen = torch.Generator().manual_seed(1)
    seqs = [dict(prompt=torch.randint(1, dm["vocab"], (40,),
                                      generator=gen).tolist(),
                 served=[3, 4, 5])]

    def out(**runs):
        s = dict(spec_, runs_as=dict(spec_["runs_as"], **runs))
        with torch.no_grad():
            return ref_moe.logits(params, s, ref_moe.hidden(params, s, seqs,
                                                            False), False)
    stated = out()
    assert spec_["as_published"] == {"moe_gates": "softmax",
                                     "moe_prefill_capacity_factor": None}
    for switch in (dict(moe_gates="softmax"),
                   dict(moe_prefill_capacity_factor=None),
                   spec_["as_published"]):
        assert not torch.equal(out(**switch), stated), switch
    with pytest.raises(ValueError, match="moe_gates"):
        out(moe_gates="sigmoid")
