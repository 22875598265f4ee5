"""The PyTorch port's ablation chassis (``AblationMetaArch``) held against the
JAX package on the CPU, in float32 at a tiny size (R-18, 64 x 96 images,
``TPU.APPROX_TOPK`` off; the FPN and the head keep their 256 channels):

- every cell of the head x adaption grid (``LRTBHead``, ``PointSetHead``,
  ``AnchorHead`` x ``Empty``, ``Unsupervised Offset``, ``Split Unsup
  Offset``, ``Supervised Offset``) and ``LRTBTopkHead``, weights carried by
  ``checkpoint/bridge.py``: head outputs within 1e-4, each loss term within
  1e-4;
- gradients within 1e-3 (max |diff| over max |JAX gradient|, per tensor)
  for one cell of each adaption and each head;
- two ``TrainStep``s of ``PointSetHead`` x ``Supervised Offset`` against two
  JAX train steps.

Predict, the geometry, the YAMLs and ``main`` are
``tests/test_torch_ablation_main.py``.

Every input comes from a numpy seed inside its test. The JAX side of a cell
is one jitted call, made once a module, of the loss (with its gradients
where checked) on one shared Flax backbone and a head drawn in numpy on the
shapes ``jax.eval_shape`` gives; the head outputs are the ones that loss
consumed (``Capture``), so no cell compiles the network twice.
"""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,  # noqa: E402
                                                   load_flax_variables)
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.engine import make_train_step  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.solver import build as tsolver  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.solver import build as jsolver  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
YAMLS = ROOT / "configs/ablation_studies"
HEAD_TOL = dict(rtol=1e-4, atol=1e-5)   # per-level head outputs
MODEL_LOSS_RTOL = 1e-4   # tests/test_torch_train.py: whole-model losses
GRAD_TOL = 1e-3          # tests/test_torch_train.py: per tensor, max |diff| / max |JAX gradient|
ADAPTIONS = ["Empty", "Unsupervised Offset", "Split Unsup Offset", "Supervised Offset"]
HEADS = ["LRTBHead", "PointSetHead", "AnchorHead"]
# the yaml each head's cells start from: all three of the repo's
HEAD_YAML = {"LRTBHead": "lrtb_unsup.yaml", "LRTBTopkHead": "lrtb_unsup.yaml",
             "PointSetHead": "pointset_sup.yaml", "AnchorHead": "anchor_empty.yaml"}
CELLS = [(h, a) for h in HEADS for a in ADAPTIONS] + [("LRTBTopkHead", "Empty")]
GRAD_CELLS = [("LRTBHead", "Unsupervised Offset"), ("PointSetHead", "Supervised Offset"),
              ("AnchorHead", "Split Unsup Offset"), ("LRTBTopkHead", "Empty")]
LOSS_KEYS = {"LRTB": ["centerness_loss", "loss_cls", "loss_loc_init", "loss_loc_refine",
                      "num_pos"],
             "other": ["loss_cls", "loss_loc_init", "loss_loc_refine", "num_pos"]}


@pytest.fixture
def one_torch_thread():
    """One torch intra-op thread for a test: under the tier's six workers on
    one shared CPU, eight threads a process made the port's many small
    operations wait on each other (``main`` 65 s against 9 s on one thread
    beside five busy processes). The gradient tests keep the default: the
    order of torch's sums changes with the thread count, and on one thread
    it flipped a ReLU of the random backbone in one cell, moving a res3
    gradient by 3.4e-3 of its largest value in the JAX comparison."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cell_id(cell):
    return f"{cell[0]}-{cell[1].replace(' ', '_')}"


def tiny_cfg(get_cfg, head="PointSetHead", adaption="Supervised Offset", **overrides):
    """R-18, fp32, exact top-k; the FPN and the head keep their 256
    channels (a GroupNorm group of 2 values at 64 amplifies fp32 rounding
    200-fold in both packages)."""
    cfg = get_cfg()
    cfg.merge_from_file(str(YAMLS / HEAD_YAML[head]))
    cfg.MODEL.META_ARCH.NAME = head
    cfg.MODEL.META_ARCH.FEAT_ADAPTION = adaption
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.APPROX_TOPK = False
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    cfg.freeze()
    return cfg


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def train_batch(seed, batch=2, g=6, hw=(64, 96)):
    """uint8 images and integer-pixel gt boxes of 6-60 pixels, the last two
    rows padding."""
    rs = np.random.RandomState(seed)
    valid = np.ones((batch, g), bool)
    valid[:, g - 2:] = False
    xy = rs.randint(0, 50, (batch, g, 2))
    boxes = np.concatenate([xy, xy + rs.randint(6, 60, (batch, g, 2))], -1)
    return {"image": rs.randint(0, 256, (batch, *hw, 3)).astype(np.uint8),
            "gt_boxes": boxes.astype(np.float32),
            "gt_classes": rs.randint(0, 80, (batch, g)).astype(np.int32),
            "gt_valid": valid}


def jnp_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}



# ------------------------------------------------------ the JAX side, shared
def lecun_normal(rs, shape):
    """Flax's ``lecun_normal``: a normal truncated at 2 sigma, scaled to a
    variance of 1 / fan-in."""
    a = rs.randn(int(np.prod(shape)))
    while (bad := np.abs(a) > 2).any():
        a[bad] = rs.randn(int(bad.sum()))
    return a.reshape(shape) / 0.87962566103423978 / np.sqrt(np.prod(shape[:-1]))


def draw_variables(det, seed, **convs):
    """A parameter tree for ``det`` drawn in numpy on the shapes
    ``jax.eval_shape`` gives (no JAX initialisation to compile): backbone and
    FPN kernels as Flax draws them (``lecun_normal``) with zero biases, FrozenBN
    buffers and GroupNorm affines away from identity, head kernels (raw
    deformable weights too) normal(0, 0.01) and the offset convs' 10x that
    (offsets of about a pixel, some samples off the map), per-level scales in
    [0.8, 1.2], the classifier's bias at the focal prior. ``convs`` maps a
    head conv to its (kernel std, bias) instead."""
    shapes = jax.eval_shape(det.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3), jnp.float32))
    rs = np.random.RandomState(seed)

    def draw(path, s):
        keys = [str(getattr(k, "key", k)) for k in path]
        leaf, owner = keys[-1], keys[-2]
        if keys[0] == "buffers":
            a = rs.uniform(0.75, 1.25, s.shape) if leaf == "scale" else rs.randn(*s.shape) * 0.05
        elif keys[1] == "backbone":
            a = lecun_normal(rs, s.shape) if leaf == "kernel" else np.zeros(s.shape)
        elif any("gn" in k for k in keys):
            a = rs.uniform(0.8, 1.2, s.shape) if leaf == "scale" else rs.randn(*s.shape) * 0.1
        elif owner.startswith("scale"):
            a = rs.uniform(0.8, 1.2, s.shape)
        elif owner in convs:
            std, bias = convs[owner]
            a = rs.randn(*s.shape) * std if leaf == "kernel" else np.full(s.shape, bias)
        elif leaf == "bias":
            a = np.full(s.shape, -np.log(99.0) if owner in ("cls_out", "cls_logits") else 0.0)
        else:
            a = rs.randn(*s.shape) * (0.1 if owner.startswith("offset_conv") else 0.01)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


class Capture:
    """Stands in for a JAX detector's ``module``: ``apply`` records the head
    outputs the loss consumes, so that one jitted loss gives both."""

    def __init__(self, module):
        self.module = module
        self.outputs = None

    def apply(self, *args, **kwargs):
        self.outputs = self.module.apply(*args, **kwargs)
        return self.outputs

    def __getattr__(self, name):
        return getattr(self.module, name)


def cell_seed(cell):
    return 60 + CELLS.index(cell)


@pytest.fixture(scope="module")
def backbone_tree():
    """One Flax initialisation of the R-18 + FPN that every cell shares, its
    FrozenBN buffers drawn away from identity. (On a tree drawn in numpy,
    fp32 rounding flipped a ReLU in res4_1 of one cell and moved that
    block's conv1 gradient by 1.06e-3 of its largest value in both
    packages' comparison.)"""
    det = jax_build_model(tiny_cfg(jax_get_cfg, "LRTBHead", "Empty"))
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                               det.init_variables(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(50)
    for node in jax.tree_util.tree_leaves(
            v["buffers"]["backbone"], is_leaf=lambda n: isinstance(n, dict) and "scale" in n):
        node["scale"] = rs.uniform(0.75, 1.25, node["scale"].shape).astype(np.float32)
        node["bias"] = (rs.randn(*node["bias"].shape) * 0.05).astype(np.float32)
    return {"params": v["params"]["backbone"], "buffers": v["buffers"]}


class JaxCells:
    """Each cell's variables (the shared backbone, the head drawn by
    ``draw_variables``) and the results of one jitted call of the JAX
    loss on ``train_batch(51)``: the total, the metrics, the head outputs the
    loss consumed and, for GRAD_CELLS, the gradients. ``fn`` keeps the jitted
    call, which a later call with other parameters or another batch of the
    same shapes reuses without compiling again."""

    def __init__(self, backbone):
        self.backbone = backbone
        self.cache = {}
        self.batch = train_batch(51)

    def __call__(self, cell):
        if cell in self.cache:
            return self.cache[cell]
        det = jax_build_model(tiny_cfg(jax_get_cfg, *cell))
        det.module = capture = Capture(det.module)
        variables = draw_variables(det, cell_seed(cell))
        variables["params"]["backbone"] = self.backbone["params"]
        variables["buffers"] = self.backbone["buffers"]
        want_grads = cell in GRAD_CELLS

        def loss_fn(params, v, b):
            total, metrics = det.loss({**v, "params": params}, b)
            return total, (metrics, capture.outputs)

        def run(v, b):
            if want_grads:
                (total, (metrics, outs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                    v["params"], v, b)
            else:
                (total, (metrics, outs)), grads = loss_fn(v["params"], v, b), None
            return outs, total, metrics, grads

        fn = jax.jit(run)
        outs, total, metrics, grads = fn(jax.tree_util.tree_map(jnp.asarray, variables),
                                         jnp_batch(self.batch))
        res = {"det": det, "fn": fn, "variables": variables,
               "outputs": jax.tree_util.tree_map(np.asarray, outs), "total": float(total),
               "metrics": {k: float(v) for k, v in metrics.items() if not k.startswith("_")},
               "grads": None if grads is None else flax_to_state_dict(
                   {"params": jax.tree_util.tree_map(np.asarray, grads)}),
               "model": port_model(cell, variables)}
        self.cache[cell] = res
        return res


@pytest.fixture(scope="module")
def jax_cells(backbone_tree):
    return JaxCells(backbone_tree)


def port_model(cell, variables, **overrides):
    model = torch_build_model(tiny_cfg(torch_get_cfg, *cell, **overrides), device="cpu")
    load_flax_variables(model, variables)
    return model


# ------------------------------------------------------------------ grid
@pytest.mark.usefixtures("one_torch_thread")
def test_bridge_carries_the_two_conv_names_apart(jax_cells):
    """``cls_conv`` (the adapted conv) beside ``cls_conv0..2`` (the tower):
    the plain conv's ``conv`` child and the deformable conv's raw leaves."""
    for cell, key, shape in ((("LRTBHead", "Empty"), "head.cls_conv.conv.weight",
                              (256, 256, 3, 3)),
                             (("PointSetHead", "Supervised Offset"), "head.cls_conv.weight",
                              (9, 256, 256))):
        variables = jax_cells(cell)["variables"]
        sd = flax_to_state_dict(variables)
        model = jax_cells(cell)["model"]
        assert len(sd) == len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
        assert sd[key].shape == shape and sd["head.cls_conv0.weight"].shape == (256, 256, 3, 3)
        head = variables["params"]["head"]
        np.testing.assert_array_equal(model.head.cls_gn2.weight.detach().numpy(),
                                      head["cls_gn2"]["scale"])
        np.testing.assert_array_equal(model.head.cls_conv0.weight.detach().numpy(),
                                      head["cls_conv0"]["kernel"].transpose(3, 2, 0, 1))
    lrtb = jax_cells(("LRTBHead", "Empty"))["variables"]
    model = jax_cells(("LRTBHead", "Empty"))["model"]
    assert float(model.head.scale_refine3.scale.detach()) == float(
        lrtb["params"]["head"]["scale_refine3"]["scale"])


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_head_outputs_match_jax(cell, jax_cells):
    want = jax_cells(cell)
    model = want["model"]
    with torch.no_grad():
        got = model(torch.from_numpy(jax_cells.batch["image"]))
    A = model.num_anchors
    widths = (80, 1, model.head.loc_dim, model.head.loc_dim)
    cells = [8 * 12, 4 * 6, 2 * 3, 1 * 2, 1 * 1]
    assert len(got[1]) == (5 if cell[0].startswith("LRTB") else 0)
    for part, (g_l, w_l) in enumerate(zip(got, want["outputs"])):
        assert len(g_l) == len(w_l)
        for lvl, (g, w) in enumerate(zip(g_l, w_l)):
            n = cells[lvl] * A
            assert tuple(g.shape) == w.shape == ((2, n) if part == 1 else (2, n, widths[part]))
            np.testing.assert_allclose(g.numpy(), w, **HEAD_TOL, err_msg=f"part {part} {lvl}")


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_loss_terms_match_jax(cell, jax_cells):
    want = jax_cells(cell)
    model = want["model"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    total, metrics = model.loss(jax_cells.batch)
    assert sorted(metrics) == sorted(want["metrics"]) == LOSS_KEYS[
        "LRTB" if cell[0].startswith("LRTB") else "other"]
    assert float(total.detach()) == pytest.approx(want["total"], rel=MODEL_LOSS_RTOL)
    for k, v in want["metrics"].items():
        assert float(metrics[k].detach()) == pytest.approx(v, rel=MODEL_LOSS_RTOL), k
    assert want["metrics"]["num_pos"] >= 5 and want["metrics"]["loss_loc_refine"] > 0
    # loss mutates nothing
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("cell", GRAD_CELLS, ids=cell_id)
def test_gradients_match_jax(cell, jax_cells):
    want = jax_cells(cell)
    cfg = tiny_cfg(torch_get_cfg, *cell)
    model = port_model(cell, want["variables"])
    tsolver.build_optimizer(cfg, model)           # applies FREEZE_AT
    total, _ = model.loss(jax_cells.batch)
    total.backward()
    checked = set()
    for name, p in model.named_parameters():
        if tsolver.frozen(cfg, name):
            assert p.grad is None, name
            continue
        assert ratio(p.grad.numpy(), want["grads"][name].numpy()) <= GRAD_TOL, name
        checked.add(name)
    assert {"head.cls_out.weight", "head.loc_init_out.weight", "head.loc_refine_out.bias",
            "head.cls_gn0.weight", "backbone.bottom_up.res4_0.conv1.weight"} <= checked
    if cell[1] != "Empty":
        # the offsets learn through the deformable sampling
        offset = {"Unsupervised Offset": "offset_conv", "Split Unsup Offset": "offset_conv_cls",
                  "Supervised Offset": "offset_conv_extend"}[cell[1]]
        assert float(getattr(model.head, offset).weight.grad.abs().max()) > 0
        assert f"head.{offset}.weight" in checked and "head.cls_conv.weight" in checked


def test_two_train_steps_match_jax(jax_cells):
    """Two ``TrainStep`` updates (SGD, momentum, weight decay) of
    ``PointSetHead`` x ``Supervised Offset`` against two steps of the JAX
    package's train step body (``engine/train_loop.py:make_train_step``: the
    loss's value and gradients, ``tx.update`` of its ``build_optimizer``,
    ``optax.apply_updates``), the gradients from the cell's jitted call: the
    losses, and every parameter after the second."""
    cell = ("PointSetHead", "Supervised Offset")
    over = {"SOLVER.WARMUP_ITERS": 0, "SOLVER.BASE_LR": 0.01}
    jcfg, cfg = tiny_cfg(jax_get_cfg, *cell, **over), tiny_cfg(torch_get_cfg, *cell, **over)
    jax_cell = jax_cells(cell)
    variables = jax_cell["variables"]
    batches = [train_batch(54), train_batch(55)]
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    tx = jsolver.build_optimizer(jcfg, jvars["params"])

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, opt_state = jvars["params"], tx.init(jvars["params"])
    want = []
    for b in batches:
        _, total, _, grads = jax_cell["fn"]({**jvars, "params": params}, jnp_batch(b))
        params, opt_state = update(grads, opt_state, params)
        want.append(float(total))
    want_params = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, params)})

    model = port_model(cell, variables, **over)
    old = {k: v.detach().clone() for k, v in model.named_parameters()}
    tstep = make_train_step(model, tsolver.build_optimizer(cfg, model), cfg)
    for b, loss in zip(batches, want):
        metrics = tstep(b)
        assert float(metrics["total_loss"]) == pytest.approx(loss, rel=MODEL_LOSS_RTOL)
    for name, p in model.named_parameters():
        delta = (p.detach() - old[name]).numpy()
        want_delta = want_params[name].numpy() - old[name].numpy()
        if tsolver.frozen(cfg, name):
            assert not delta.any(), name
            continue
        ulp = np.spacing(np.abs(old[name].numpy()).max())
        np.testing.assert_allclose(delta, want_delta, rtol=0,
                                   atol=1e-2 * np.abs(want_delta).max() + 2 * ulp, err_msg=name)
