"""The seeded weights (``perfbench.weights``) on the CPU: the draws of the
benchmark's configurations held bitwise to the draws made before the
references' ``weight_spec`` hooks existed; a model of RTMUAVDet's build
(GroupNorm(1), a per-sample filter made by linear layers, a head whose convs
are named ``obj_{h}`` / ``bbox_{h}`` with its prior in its own hook) drawn as
the rules and its hook say, and driven through the ``detect`` kind end to
end by code outside the harness alone; a tensor that no rule covers is an
error that names it."""

import hashlib
import json
import math
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import perfbench.kinds.detect as detect_kind
from perfbench.drive import reference_model
from perfbench.faults import FAULTS
from perfbench.reference import detect as ref_detect
from perfbench.reference.common import ConvBN, he_std
from perfbench.tests.helpers import tiny_mix
from perfbench.weights import seeded_state

BENCH = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 5

# sha256 of seeded_state on the CPU (each key, dtype, shape and its bytes, in
# the state's order), computed at commit 542137b, whose weights.py held the
# heads' prior and the residual branches' small scale as rules of its own
PARENT_DIGESTS = {
    ("dyyolo", 2 ** 31 + 5, "float32"):
        "aa4d9cf4b7b10319709435195269d6ac3e53bbfe20fd3f5922067168f205c1a4",
    ("dyyolo", 2 ** 31 + 5, "bfloat16"):
        "da462b3011557db63ac73698e2cecef8ebf877b6517b29ab44983ec1ad22f55e",
    ("dyyolo", 3400000001, "float32"):
        "97bea6ed475ca7b6af3ff6dc84fb6a2642b9322f4c3936b1e8dfafe6b99518e1",
    ("dyyolo", 3400000001, "bfloat16"):
        "2174881a91f0551d96799393e015e72732b52887f7a4063609b7e865ff9f617e",
    ("dysoem_simfpn", 2 ** 31 + 5, "float32"):
        "1388321a1259e8191ae100868279e1918215077360f1d0eb595765e4a17a63a8",
    ("dysoem_simfpn", 2 ** 31 + 5, "bfloat16"):
        "22354d36efc6d5db597face75f69d2cd57fe122427b8d2fecad8c63b0fe80b80",
    ("dysoem_simfpn", 3400000001, "float32"):
        "a3d9f2a784ec5576399442903a89cf234e758518629421bf8dcbe4a5b725b3e2",
    ("dysoem_simfpn", 3400000001, "bfloat16"):
        "7c0550f5033163eaabecafdc23ea826282ae36d0532f4cb596ab1a6302b11aaa",
}


def _digest(state: dict) -> str:
    h = hashlib.sha256()
    for key, t in state.items():
        h.update(f"{key} {t.dtype} {tuple(t.shape)}\n".encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name, seed, dtype", sorted(PARENT_DIGESTS))
def test_the_configurations_draws_are_bitwise_those_before_the_hooks(
        name, seed, dtype):
    torch.set_num_threads(4)
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    state = seeded_state(reference_model(config, "meta"), seed, "cpu",
                         getattr(torch, dtype))
    assert _digest(state) == PARENT_DIGESTS[name, seed, dtype]


class MDyConv(nn.Module):
    """RTMUAVDet's dynamic conv without its base conv: a per-sample k x k
    filter and a per-channel scale, both made by linear layers from the
    pooled map, the filter run as one grouped conv with groups = B, plus
    the input."""

    def __init__(self, c: int, k: int = 3, hidden: int = 16):
        super().__init__()
        self.k = k
        self.attention = nn.Linear(c, hidden)
        self.channel_fc = nn.Linear(hidden, c)
        self.kernel_fc = nn.Linear(hidden, k * k)

    def forward(self, x):
        b = x.shape[0]
        a = F.relu(self.attention(x.mean(dim=(2, 3))))
        kernel = self.kernel_fc(a).reshape(b, 1, self.k, self.k)
        y = F.conv2d(x.transpose(0, 1), kernel, padding=self.k // 2,
                     groups=b).transpose(0, 1)
        return y * self.channel_fc(a)[:, :, None, None] + x


class RTMHead(nn.Module):
    """Per map a 1x1 objectness conv ``obj_{h}`` and a box conv
    ``bbox_{h}``, named as RTMUAVDet's, with their draws and the objectness
    prior declared in ``weight_spec``: -> per map (bbox (B, A, H, W, 4),
    obj (B, A, H, W, 1)) logits."""

    def __init__(self, channels, n_anchors: int):
        super().__init__()
        self.n_maps, self.n_anchors = len(channels), n_anchors
        for h, c in enumerate(channels):
            self.add_module(f"obj_{h}", nn.Conv2d(c, n_anchors, 1))
            self.add_module(f"bbox_{h}", nn.Conv2d(c, 4 * n_anchors, 1))

    def weight_spec(self) -> dict:
        spec = {}
        for h in range(self.n_maps):
            spec[f"obj_{h}.weight"] = ("normal", 0.1)
            spec[f"obj_{h}.bias"] = ("const", -math.log(99.0))
            spec[f"bbox_{h}.weight"] = ("normal", 0.1)
        return spec

    def forward(self, maps):
        outs, a = [], self.n_anchors
        for h, x in enumerate(maps):
            obj = getattr(self, f"obj_{h}")(x)
            box = getattr(self, f"bbox_{h}")(x)
            b, _, hh, ww = obj.shape
            outs.append((box.view(b, a, 4, hh, ww).permute(0, 1, 3, 4, 2),
                         obj.view(b, a, 1, hh, ww).permute(0, 1, 3, 4, 2)))
        return outs


class TinyRTM(nn.Module):
    """Two stride-2 convs to stride 4, GroupNorm(1) and an MDyConv there,
    a stride-2 conv to stride 8, heads on both maps; float32 only."""

    def __init__(self, hparams, width: int = 64):
        super().__init__()
        self.stem = ConvBN(3, width // 2, 3, 2, 1, act="silu")
        self.down1 = ConvBN(width // 2, width, 3, 2, 1, act="silu")
        self.group_norm = nn.GroupNorm(1, width)
        self.mdy_conv = MDyConv(width)
        self.down2 = ConvBN(width, 2 * width, 3, 2, 1, act="silu")
        self.head = RTMHead((width, 2 * width), len(hparams["anchors"][0]))

    def forward(self, x, quant=None):
        """x (B, H, W, 3) frames in [0, 1] -> per map (bbox, obj) logits;
        ``quant``, the control's float8, is not taken here."""
        assert quant is None
        x = self.down1(self.stem(x.float().permute(0, 3, 1, 2)))
        x1 = self.mdy_conv(self.group_norm(x))
        return self.head([x1, self.down2(x1)])


# RTMUAVDet's anchors times their heads' strides (4, 8), as
# ``reference.detect.candidates`` takes them; no score threshold, as
# ``make_rtm_detector`` has none
CONFIG = {
    "name": "tiny_rtm", "entry": "tiny_rtm", "reference": "tiny_rtm",
    "dtype": "bfloat16",
    "hparams": {"anchors": [[[116, 92], [192, 120], [268, 152]],
                            [[728, 432], [960, 600], [1256, 480]]]},
    "detector": {"score_threshold": 0.0, "nms_iou": 0.5, "pre_nms_topk": 512,
                 "max_det": 300, "cover_box": 0.2},
}
# the limits that the benchmark's detect cells hold their numbers to
LIMITS = {"logit_gap": 0.3, "box_gap": 0.3, "nms_overlap": 0.5001}


def tiny_reference(config: dict, device) -> nn.Module:
    with torch.device(device):
        return TinyRTM(config["hparams"])


class Detections(NamedTuple):
    boxes: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor


def serve_the_reference(config: dict, state: dict, device, input_size: int):
    """An entry that serves the reference itself: its heads, then the
    reference's decode, top-k and greedy NMS, padded to ``max_det``
    slots."""
    model = tiny_reference(config, device)
    model.load_state_dict(state)
    model.eval()
    d = config["detector"]

    @torch.no_grad()
    def detect(frames) -> Detections:
        cand = ref_detect.candidates(
            model(frames.float() / 255.0), config["hparams"]["anchors"],
            input_size, d["pre_nms_topk"])
        rows = torch.arange(len(frames), device=frames.device)[:, None]
        top = cand["top"]
        dets = ref_detect.detections(
            cand["boxes"][rows, top], cand["logits"][rows, top],
            d["score_threshold"], d["nms_iou"], d["max_det"])
        return Detections(*detect_kind.padded(dets, d["max_det"]))

    return detect


def _spread_ok(t: torch.Tensor, std: float) -> bool:
    """Mean 0 and standard deviation ``std``, each within four standard
    errors of its estimate."""
    n = t.numel()
    return (abs(float(t.mean())) < 4 * std / math.sqrt(n)
            and abs(float(t.std()) / std - 1) < 4 / math.sqrt(2 * n))


def test_groupnorm_linear_and_a_declared_head_get_their_draws():
    model = tiny_reference(CONFIG, "meta")
    state = seeded_state(model, SEED, "cpu")
    gn = state["group_norm.weight"]
    assert 0.8 <= float(gn.min()) and float(gn.max()) <= 1.2
    assert float(gn.max() - gn.min()) > 0.3
    assert _spread_ok(state["group_norm.bias"], 0.05)
    for name in ("attention", "channel_fc", "kernel_fc"):
        w = state[f"mdy_conv.{name}.weight"]
        assert _spread_ok(w, he_std(w.shape[1]))
        assert torch.equal(state[f"mdy_conv.{name}.bias"],
                           torch.zeros_like(state[f"mdy_conv.{name}.bias"]))
    for h in range(2):
        obj_b = state[f"head.obj_{h}.bias"]
        assert torch.equal(obj_b, torch.full_like(obj_b, -math.log(99.0)))
        assert torch.equal(state[f"head.bbox_{h}.bias"],
                           torch.zeros_like(state[f"head.bbox_{h}.bias"]))
        w = torch.cat([state[f"head.obj_{h}.weight"].flatten(),
                       state[f"head.bbox_{h}.weight"].flatten()])
        assert _spread_ok(w, 0.1)


class Unruled(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3)
        self.norm = nn.LayerNorm(8)


class MisnamedHook(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3)

    def weight_spec(self) -> dict:
        return {"conv.scale": ("const", 1.0)}


@pytest.mark.parametrize("module, key", [(Unruled, "'norm.weight'"),
                                         (MisnamedHook, "'conv.scale'")])
def test_a_tensor_no_rule_covers_is_an_error_that_names_it(module, key):
    with torch.device("meta"):
        model = module()
    with pytest.raises(ValueError, match=key):
        seeded_state(model, SEED, "cpu")


@pytest.mark.parametrize("fault", [None, "score_altered", "box_moved"])
def test_a_model_of_rtmuavdets_build_runs_through_the_detect_kind(
        monkeypatch, fault):
    """The kind's lookups of the reference and the entry replaced by this
    file's own: nothing of the harness edited, no file added to it."""
    torch.set_num_threads(4)
    build = serve_the_reference if fault is None \
        else FAULTS[fault](serve_the_reference)
    monkeypatch.setattr(detect_kind, "reference_model", tiny_reference)
    monkeypatch.setattr(detect_kind, "entry",
                        lambda name: SimpleNamespace(build=build))
    mix = tiny_mix(json.loads((BENCH / "traffic" / "serve_b16.json")
                              .read_text()))
    cell = detect_kind.Cell(CONFIG, mix, SEED, "cpu")
    cell.setup()
    assert cell.window(0.2)["attempted"] > 0
    cell.free()
    parts = cell.check()
    correct = not any(p[k] > LIMITS[k] for p in parts for k in LIMITS)
    assert correct is (fault is None)
    if fault is None:
        assert max(p["logit_gap"] for p in parts) < 1e-4
