"""``sot_tpu_torch/conv_route_distance.py``: the conv routes' gradient
distances from one state, at a tiny size on the CPU.

On the CPU the ``f32`` and ``cudnn`` routes are both ``nn.Conv1d``'s
forward, so their distances are exactly 0 and each reruns bit-equal; the
float64 route differs from them by rounding, amplified by the loss's kinks
(1.5e-4 of the gradient's norm at this size), far below 1e-2.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from sot_tpu_torch import conv_route_distance as crd
from sot_tpu_torch.models.encoder import PESTOEncoder

TINY = dict(n_samples=1024, cqt_fmin=261.6, batch_size=8, transform_n_fft=512,
            transform_hop=128, dataset_size=32)


@pytest.fixture(scope="module")
def doc():
    return crd.run("SOT-2048-Anneal", 42, 4, 2, device="cpu", overrides=TINY)


def test_records_every_few_steps(doc):
    assert [r["step"] for r in doc["records"]] == [0, 2]
    assert doc["conv_weights"] == ["conv1.weight", "prefilt.0.weight"]
    assert (doc["experiment"], doc["seed"], doc["device"]) == ("SOT-2048-Anneal", 42, "cpu")
    pairs = {f"{a}-{b}" for a, b in crd.PAIRS}
    for part in ("all", "conv"):
        assert set(doc["summary"][part]) == pairs
        for pair in pairs:
            values = [r[part][pair] for r in doc["records"]]
            assert doc["summary"][part][pair]["max"] == max(values)


@pytest.mark.parametrize("part", ["all", "conv"])
def test_cpu_routes_agree_and_f64_is_rounding_away(doc, part):
    for r in doc["records"]:
        d = r[part]
        assert d["f32-cudnn"] == d["f32-f32_again"] == d["cudnn-cudnn_again"] == 0.0
        assert d["f32-f64"] == d["cudnn-f64"]
        assert 0.0 < d["f32-f64"] < 1e-2


@pytest.mark.parametrize("route", ["f32", "cudnn", "f64"])
def test_conv_route_swaps_and_restores_the_forward(route):
    enc = PESTOEncoder(generator=torch.Generator().manual_seed(1))
    layer = enc.conv1
    x = torch.randn(3, 1, 285, generator=torch.Generator().manual_seed(2))
    plain = nn.Conv1d.forward(layer, x)
    with crd.conv_route(enc, route):
        got = layer(x)
    if route == "f64":
        want = F.conv1d(x.double(), layer.weight.double(), layer.bias.double(),
                        padding=layer.padding).float()
        assert torch.equal(got, want)
    else:
        assert torch.equal(got, plain)
    assert "forward" not in layer.__dict__
    assert torch.equal(layer(x), plain)
