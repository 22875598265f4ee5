"""The port's serving path (``slenderobjdet_torch/serving.py``, the
registered kernel operators) on the CPU, on the tiny FCOS of
``tests/conftest.py`` (R-18, res3-res5, P6/P7 from P5, float32):

- ``quantize_variables`` gives JAX's ``q`` and ``s`` bit for bit through
  the bridge;
- an exported artifact reloads bit-equal to the live model, holds exactly
  its three files, and loads in a process that imports no model module;
- a weight-only int8 artifact equals the live model on its dequantized
  weights bit for bit, and the live float model within the JAX tool's
  ``--verify`` tolerances;
- each operator's fake (meta) outputs have its plain version's shapes,
  dtypes and strides, and its CPU implementation is the plain version.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from slenderobjdet_torch import serving
from slenderobjdet_torch.checkpoint.bridge import flax_to_state_dict, load_flax_variables
from slenderobjdet_torch.config import get_cfg as torch_get_cfg
from slenderobjdet_torch.models import build_model as torch_build_model
from slenderobjdet_torch.models.layers import prior_bias
from slenderobjdet_torch.ops import corner_pool, fused_bottleneck, fused_stem, nms, rotated
from slenderobjdet_torch.tools.export_serving import verify_outputs
from slenderobjdet_tpu import serving as jserving
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg
from slenderobjdet_tpu.models import build_model as jax_build_model

ROOT = Path(__file__).resolve().parents[1]
BATCH, HW = 2, (64, 64)
JAX_META_KEYS = {"batch_size", "image_hw", "platforms", "quantize", "inputs", "outputs"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the tier runs six workers on one CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(get_cfg):
    cfg = get_cfg()
    cfg.MODEL.BACKBONE.NAME = "build_retinanet_resnet_fpn_backbone_use_p5"
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    cfg.MODEL.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.APPROX_TOPK = False
    cfg.freeze()
    return cfg


def draw_variables(det, hw=HW, seed=0):
    """The detector's Flax variables drawn in numpy on their
    ``jax.eval_shape`` (no init program is compiled), as the JAX package
    initialises them in kind: the head's kernels normal with std 0.01, the
    others with std sqrt(1 / fan_in), scales 1, everything else 0 (FrozenBN
    at the identity); numpy float32 leaves."""
    shapes = jax.eval_shape(lambda k: det.init_variables(k, hw, batch_size=1),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            head = any(getattr(p, "key", "") == "head" for p in path)
            std = 0.01 if head else 1 / np.sqrt(np.prod(leaf.shape[:-1]))
            return (rs.randn(*leaf.shape) * std).astype(np.float32)
        if name == "scale":
            return np.ones(leaf.shape, np.float32)
        return np.zeros(leaf.shape, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def request(seed=1):
    rs = np.random.RandomState(seed)
    return {"image": rs.randint(0, 256, (BATCH, *HW, 3)).astype(np.uint8),
            "scale": np.array([1.0, 0.8], np.float32),
            "orig_size": np.array([HW, [51, 51]], np.float32)}


@pytest.fixture(scope="module")
def jax_variables():
    return draw_variables(jax_build_model(tiny_cfg(jax_get_cfg)))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory, jax_variables):
    """The tiny FCOS from the JAX weights, its classifier bias at 0 so that
    random weights give detections, exported at B = 2, 64 x 64."""
    model = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    load_flax_variables(model, jax_variables)
    with torch.no_grad():
        model.head.cls_logits.bias.zero_()
    path = str(tmp_path_factory.mktemp("serving") / "fcos")
    serving.export_detector(model, path, batch_size=BATCH, image_hw=HW)
    return model, path


def test_quantize_variables_equals_jax_through_the_bridge(jax_variables):
    want = jserving.quantize_variables(jax_variables)
    model = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    load_flax_variables(model, jax_variables)
    got = serving.quantize_variables(serving.model_variables(model), serving.kernel_names(model))

    def leaf(tree, key):
        if isinstance(tree, dict):
            return {k: leaf(v, key) for k, v in tree.items()} if set(tree) != {"q", "s"} \
                else np.asarray(tree[key], np.float32)
        return tree

    # the bridge renames and re-lays out q as it does a kernel; s is 1-d
    want_q = flax_to_state_dict(leaf(want, "q"))
    want_s = flax_to_state_dict(leaf(want, "s"))
    quantized = {k for k, v in got.items() if isinstance(v, dict)}
    assert quantized == {k for k in want_q if want_q[k].dim() >= 2}
    assert len(quantized) == len(serving.kernel_names(model)) > 30
    for k in quantized:
        assert got[k]["q"].dtype == torch.int8 and got[k]["s"].dtype == torch.float32
        assert torch.equal(got[k]["q"].float(), want_q[k]), k
        assert torch.equal(got[k]["s"], want_s[k]), k
    plain = serving.model_variables(model)
    assert sorted(got) == sorted(plain)
    for k in set(got) - quantized:
        assert torch.equal(got[k], plain[k]), k
    back = serving.dequantize_variables(got)
    w = dict(model.named_parameters())["head.cls_tower0.weight"]
    assert (back["head.cls_tower0.weight"] - w).abs().max() <= \
        w.abs().amax(dim=(1, 2, 3)).max() / 254 + 1e-7


def test_export_reload_is_bit_equal_on_the_cpu(artifact):
    model, path = artifact
    req = request()
    got = serving.load_detector(path)(req)
    want = model.predict(req)
    assert sorted(got) == sorted(want) == ["boxes", "classes", "scores", "valid"]
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert int(want["valid"].sum()) > 0
    # the weights are an input of the program, not baked into it
    program = torch.export.load(os.path.join(path, "model.pt2"))
    assert not program.state_dict
    assert sum(t.numel() for t in program.constants.values()) < 1000
    nodes = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "slenderobjdet.nms.default" in nodes


def test_the_artifact_holds_exactly_its_files(artifact):
    model, path = artifact
    assert sorted(os.listdir(path)) == sorted(serving.ARTIFACT_FILES)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == JAX_META_KEYS - {"platforms"} | {"device"}
    assert meta == {"batch_size": BATCH, "image_hw": list(HW), "device": "cpu",
                    "quantize": "none", "inputs": serving.INPUTS,
                    "outputs": ["boxes", "scores", "classes", "valid"]}
    weights = torch.load(os.path.join(path, "weights.pt"), weights_only=True)
    assert sorted(weights) == sorted(serving.model_variables(model))
    with pytest.raises(ValueError, match="exported on 'cpu'"):
        serving.load_detector(path, "meta")
    with pytest.raises(ValueError, match="uint8 images"):
        serving.load_detector(path)({**request(), "image": request()["image"][:1]})


def test_loading_imports_no_model_module(artifact):
    """A serving process needs torch and the operators only: no config, no
    model module and no JAX."""
    model, path = artifact
    req = request()
    want = model.predict(req)
    code = f"""
import sys, numpy as np, torch
from slenderobjdet_torch.serving import load_detector
torch.set_num_threads(1)      # as this module: the CPU convs' sums in one order
rs = np.random.RandomState(1)
out = load_detector({path!r})({{"image": rs.randint(0, 256, ({BATCH}, {HW[0]}, {HW[1]}, 3)).astype(np.uint8),
    "scale": np.array([1.0, 0.8], np.float32), "orig_size": np.array([{list(HW)}, [51, 51]], np.float32)}})
bad = [m for m in sys.modules if m.startswith(("slenderobjdet_torch.models",
       "slenderobjdet_torch.config", "slenderobjdet_tpu", "jax", "flax"))]
assert not bad, bad
torch.save({{k: v for k, v in out.items()}}, {path!r} + "/../reloaded.pt")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = torch.load(os.path.join(path, "..", "reloaded.pt"), weights_only=True)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_quantized_artifact_within_jax_tolerances(tmp_path, jax_variables):
    """The weight-only int8 artifact equals the live model on the
    dequantized weights bit for bit, and the float model within the JAX
    tool's ``--verify`` tolerances (the JAX tool's case: weights from a seed,
    the classifier at the focal prior)."""
    model = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    load_flax_variables(model, jax_variables)
    with torch.no_grad():
        model.head.cls_logits.bias.fill_(prior_bias(model.head.prior_prob))
    path = str(tmp_path / "fcos_q")
    serving.export_detector(model, path, batch_size=BATCH, image_hw=HW, quantize=True)
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["quantize"] == "int8-weight-only"
    req = request(seed=2)
    got = serving.load_detector(path)(req)
    verify_outputs(got, model.predict(req), quantize=True)
    weights = torch.load(os.path.join(path, "weights.pt"), weights_only=True)
    assert weights["head.cls_tower0.weight"]["q"].dtype == torch.int8
    deq = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    deq.load_state_dict({k: v for k, v in serving.dequantize_variables(weights).items()
                         if k in deq.state_dict()})
    assert not torch.equal(deq.head.cls_tower0.weight, model.head.cls_tower0.weight)
    want = deq.predict(req)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------- the operators
def _stem_args(g):
    return (torch.randn(2, 16, 24, 3, generator=g), torch.randn(7, 7, 3, 8, generator=g),
            torch.rand(8, generator=g) + 0.5, torch.randn(8, generator=g))


def _block_args(g, proj):
    cin, cm, cout = 8, 4, (16 if proj else 8)
    t = [torch.randn(2, 5, 6, cin, generator=g), torch.randn(cin, cm, generator=g),
         torch.randn(cm, generator=g), torch.randn(3, 3, cm, cm, generator=g),
         torch.randn(cm, generator=g), torch.randn(cm, cout, generator=g),
         torch.randn(cout, generator=g)]
    return (*t, *((torch.randn(cin, cout, generator=g), torch.randn(cout, generator=g))
                  if proj else (None, None)))


def _boxes(g, b, n):
    xy = torch.randint(0, 40, (b, n, 2), generator=g).float()
    return torch.cat([xy, xy + torch.randint(2, 20, (b, n, 2), generator=g).float()], -1)


def _rboxes(g, n):
    return torch.cat([torch.rand(n, 2, generator=g) * 50, torch.rand(n, 2, generator=g) * 20 + 2,
                      (torch.randint(0, 7, (n, 1), generator=g) * 15 - 45).float()], -1)


def _op_cases():
    g = torch.Generator().manual_seed(0)
    b, s = _boxes(g, 2, 40), torch.rand(2, 40, generator=g)
    c, v = torch.randint(0, 3, (2, 40), generator=g), torch.rand(2, 40, generator=g) > 0.2
    rb = _rboxes(g, 30)
    a4 = torch.randn(2, 3, 5, 7, generator=g)
    return {
        "nms_classes": (torch.ops.slenderobjdet.nms, (b, s, c, v, None, 0.5, 10),
                        lambda: nms.batched_nms(b, s, c, 0.5, 10, valid=v)),
        "nms_rows": (torch.ops.slenderobjdet.nms, (b, s, None, v, torch.tensor([0.0, 100.0]), 0.5, 10),
                     lambda: nms.nms_select(b + torch.tensor([0.0, 100.0])[:, None, None], s,
                                            0.5, 10, valid=v)),
        "nms_plain": (torch.ops.slenderobjdet.nms, (b, s, None, None, None, 0.6, 7),
                      lambda: nms.nms_select(b, s, 0.6, 7)),
        "fused_stem": (torch.ops.slenderobjdet.fused_stem, _stem_args(g), None),
        "fused_bottleneck": (torch.ops.slenderobjdet.fused_bottleneck, _block_args(g, False), None),
        "fused_bottleneck_proj": (torch.ops.slenderobjdet.fused_bottleneck, _block_args(g, True),
                                  None),
        "rotated_iou": (torch.ops.slenderobjdet.rotated_iou, (rb, rb[:11]),
                        lambda: rotated.plain_pairwise_rotated_iou(rb, rb[:11])),
        "rotated_nms": (torch.ops.slenderobjdet.rotated_nms, (rb[None], s[:1, :30], None, 0.4, 8),
                        lambda: rotated.plain_rotated_nms(rb[None], s[:1, :30], 0.4, 8)),
        "corner_pool_tl": (torch.ops.slenderobjdet.corner_pool, (a4, a4.flip(2), "tl"),
                           lambda: corner_pool.plain_tl_pool(a4, a4.flip(2))),
        "corner_pool_br": (torch.ops.slenderobjdet.corner_pool, (a4, a4.flip(3), "br"),
                           lambda: corner_pool.plain_br_pool(a4, a4.flip(3))),
    }


OP_CASES = _op_cases()


@pytest.mark.parametrize("case", list(OP_CASES))
def test_operator_fake_shapes_equal_its_plain_version(case):
    op, args, plain = OP_CASES[case]
    if plain is None:
        plain = {"fused_stem": lambda: fused_stem.reference_stem(*args)}.get(
            case, lambda: fused_bottleneck.reference_bottleneck(*args))
    want = plain()
    got = op(*args)
    want_t = want if isinstance(want, tuple) else (want,)
    got_t = got if isinstance(got, tuple) else (got,)
    for w, r in zip(want_t, got_t):
        assert torch.equal(r, w)            # the CPU implementation is the plain version
    with FakeTensorMode() as mode:
        fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args])
    fake_t = fake if isinstance(fake, tuple) else (fake,)
    assert len(fake_t) == len(want_t)
    for f, w in zip(fake_t, want_t):
        assert (f.shape, f.dtype, f.stride()) == (w.shape, w.dtype, w.stride()), case
    torch.library.opcheck(op, args, test_utils="test_schema")
