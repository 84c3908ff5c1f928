"""Segmentation training in semantic_meshes_torch (models.training) against
the JAX package's (flax + optax) on the same inputs, on the CPU.

Mirrors the five tests of tests/test_training.py (the data-parallel one
in a 4-rank gloo world of tests/_torch_train_worker.py processes, which
never import JAX) and adds parity: `softmax_xent_ignore` within 1e-6 of
JAX's; one AdamW update on the same float32 gradients within ~1e-7 of
`optax.adamw`'s; one `train_step` against the JAX trainer's `_step` from
the same params; the JAX trainer's params and optimizer state after k
steps carried across (`convert.flax_params` / `adamw_state`), then one
more step in each; flax reading `dump_flax` bit for bit and `load_flax`
reading a JAX trainer's `save`; and the reference's shard-mean loss
(pmean of the shards' means) pinned with uneven ignore labels.

Tolerances of a train step between the frameworks. The forward's logits
carry the bf16 / GroupNorm differences of tests/_torch_models.py; over
four seeds (UNet and RGBDUNet at widths (8, 16, 32), 32x32, batch 4,
lr 3e-3) the first loss differed by 2.9e-5 - 1.7e-4 relative, so
LOSS_RTOL is 1e-3. Adam's first update is about +-lr whatever the
gradient's size, so a gradient that changes sign between the frameworks
moves a parameter by up to 2 lr: every element of (port dp - JAX dp) is
within 2 lr + 1e-6, and over the same seeds 0.9900 - 0.9941 of the
elements were within lr / 10 (DP_SHARE 0.97 below). A wrong update rule
moves most elements by O(lr).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization as flax_serialization

from semantic_meshes.models import segmentation as jseg
from semantic_meshes.models import training as jtraining
from semantic_meshes_torch import convert
from semantic_meshes_torch.models import segmentation, serialization
from semantic_meshes_torch.models.training import (
    IGNORE_LABEL, SegmentationTrainer, make_data_parallel_step,
    softmax_xent_ignore)
from _torch_sharded import World

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_WORKER = os.path.join(REPO, "tests", "_torch_train_worker.py")
CPU = "cpu"
LR = 3e-3
LOSS_RTOL = 1e-3
DP_SHARE = 0.97
JAX_ARCHS = {"unet": jseg.UNet, "pspnet": jseg.PSPNet, "rgbd": jseg.RGBDUNet}


def _toy_batch(rng, B, H, W, C, with_depth=False):
    # test_training.py's learnable toy task: label = 1 where the red
    # channel is bright
    image = rng.random((B, H, W, 3)).astype(np.float32)
    labels = (image[..., 0] > 0.5).astype(np.int32)
    labels[:, 0, 0] = -1  # some ignore pixels
    batch = {"image": image, "labels": labels}
    if with_depth:
        batch["depth"] = rng.random((B, H, W, 1)).astype(np.float32)
    return batch


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_trainer(classes, input_hw, arch, widths, learning_rate, seed):
    """The JAX package's SegmentationTrainer with its flax init jitted
    (its constructor inits eagerly, compiling op by op: ~20 s); every
    other attribute as the constructor sets it."""
    tr = object.__new__(jtraining.SegmentationTrainer)
    tr.classes, tr.input_hw, tr.arch = classes, tuple(input_hw), arch
    tr.model = JAX_ARCHS[arch](classes=classes, widths=tuple(widths))
    dummy = [jnp.zeros((1,) + tr.input_hw + (3,), jnp.float32)]
    if arch == "rgbd":
        dummy.append(jnp.zeros((1,) + tr.input_hw + (1,), jnp.float32))
    tr.params = jax.jit(tr.model.init)(jax.random.PRNGKey(seed), *dummy)
    tr.tx = optax.adamw(learning_rate, weight_decay=1e-4)
    tr.opt_state = tr.tx.init(tr.params)
    tr._step = tr._build_step()
    return tr


def _state(trainer):
    return {k: v.detach().clone() for k, v in trainer.params.items()}


def assert_step_close(before, after, want_before, want_after, lr=LR):
    """One step's update (after - before) against another's, state_dicts
    both, within the bounds of the docstring."""
    err = torch.cat([((after[k] - before[k])
                      - (want_after[k] - want_before[k])).abs().reshape(-1)
                     for k in before])
    assert float(err.max()) <= 2 * lr + 1e-6, float(err.max())
    share = float((err <= lr / 10).float().mean())
    assert share >= DP_SHARE, share


def assert_update_close(port_before, port_after, jax_before, jax_after,
                        arch, widths, lr=LR):
    """(port dp) against (JAX dp) within the bounds of the docstring."""
    assert_step_close(port_before, port_after,
                      convert.segmentation_params(jax_before, arch, widths),
                      convert.segmentation_params(jax_after, arch, widths),
                      lr)


# ------------------------------------------------ mirrors of test_training.py

def test_xent_ignore():
    logits = torch.tensor([[10.0, -10.0], [10.0, -10.0]])[None, None]
    labels = torch.tensor([[0, -1]])[None]
    # only the first pixel counts; it is correct -> near-zero loss
    assert float(softmax_xent_ignore(logits, labels)) < 1e-3


def test_loss_decreases():
    rng = np.random.default_rng(0)
    tr = SegmentationTrainer(classes=2, input_hw=(32, 32),
                             widths=(8, 16, 32), learning_rate=3e-3,
                             device=CPU)
    batch = _toy_batch(rng, 4, 32, 32, 2)
    first = tr.train_step(batch)
    for _ in range(15):
        last = tr.train_step(batch)
    assert last < first * 0.7, (first, last)


def test_rgbd_trainer_steps():
    rng = np.random.default_rng(1)
    tr = SegmentationTrainer(classes=3, input_hw=(32, 32),
                             widths=(8, 16, 32), arch="rgbd", device=CPU)
    batch = _toy_batch(rng, 2, 32, 32, 3, with_depth=True)
    assert np.isfinite(tr.train_step(batch))
    with pytest.raises(ValueError, match="rgbd"):
        tr.predict_logits(batch["image"])


def test_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    tr = SegmentationTrainer(classes=2, input_hw=(32, 32),
                             widths=(8, 16, 32), device=CPU)
    tr.train_step(_toy_batch(rng, 2, 32, 32, 2))
    tr.save(tmp_path / "params.msgpack")
    tr2 = SegmentationTrainer(classes=2, input_hw=(32, 32),
                              widths=(8, 16, 32), seed=1, device=CPU)
    tr2.load(tmp_path / "params.msgpack")
    for k, v in tr.params.items():
        assert torch.equal(v, tr2.params[k]), k
    logits = tr2.predict_logits(_toy_batch(rng, 1, 32, 32, 2)["image"])
    assert tuple(logits.shape) == (1, 32, 32, 2)


# the data-parallel world: test_training.py's case (8 images of 16x16 on
# 4 ranks) and the shard-mean case (4 images of 8x8, 128 and 32 valid
# pixels in the two shards of a (2, 2) mesh's "views")
TRAINER = dict(classes=2, input_hw=(16, 16), widths=(8, 16), seed=0)


def _uneven_batch():
    rng = np.random.default_rng(7)
    batch = _toy_batch(rng, 4, 8, 8, 2)
    labels = batch["labels"]
    labels[:2, 0, 0] = (batch["image"][:2, 0, 0, 0] > 0.5)  # all 64 valid
    labels[2:] = IGNORE_LABEL
    labels[2:, :4, :4] = (batch["image"][2:, :4, :4, 0] > 0.5)  # 16 each
    assert [(labels[k] >= 0).sum() for k in range(4)] == [64, 64, 16, 16]
    return batch


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    mirror = _toy_batch(np.random.default_rng(3), 8, 16, 16, 2)
    np.savez(tmp / "mirror.npz", **mirror)
    np.savez(tmp / "uneven.npz", **_uneven_batch())
    cases = [dict(name="mirror", layout=[4, 1], inputs=str(tmp / "mirror.npz"),
                  trainer=TRAINER),
             dict(name="uneven", layout=[2, 2], inputs=str(tmp / "uneven.npz"),
                  trainer=TRAINER)]
    world = World(tmp, cases, n=4, worker=TRAIN_WORKER)
    yield world, mirror
    world.close()


def _rank_params(rank):
    return {k[len("param."):]: torch.from_numpy(v) for k, v in rank.items()
            if k.startswith("param.")}


def test_data_parallel_matches_single_chip(dp_world):
    """test_training.py's data-parallel test in a 4-rank gloo world: every
    rank takes the same step (bit for bit), and it matches one process's
    step on the whole batch within the JAX test's bounds."""
    world, batch = dp_world
    ranks = world.ranks("mirror")
    assert [int(r["views"]) for r in ranks] == [0, 1, 2, 3]
    tr = SegmentationTrainer(**TRAINER, device=CPU)
    before = _state(tr)
    loss = tr.train_step(batch)
    np.testing.assert_allclose(float(ranks[0]["loss"]), loss, atol=1e-5)
    got = _rank_params(ranks[0])
    for r in ranks[1:]:
        assert float(r["loss"]) == float(ranks[0]["loss"])
        for k, v in _rank_params(r).items():
            assert torch.equal(v, got[k]), k
    # bf16 convs reduce in another order per batch split, and AdamW
    # normalizes the (tiny) gradients: agreement to the scale of one
    # update step, as test_training.py holds it
    for k, v in tr.params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-3)
    # that bound alone holds without a step (lr 3e-4): the data-parallel
    # update is held against the single process's as the JAX one is
    # (read: max |d| 5.98e-4, 0.99984 of the elements within lr / 10; a
    # step that skips AdamW reads 0.0)
    assert_step_close(before, got, before, _state(tr),
                      lr=tr.optimizer.defaults["lr"])


def test_data_parallel_loss_is_the_mean_of_shard_means(dp_world):
    """The reference's pmean fault, mirrored and pinned: with 128 and 32
    valid pixels in the two shards of `views`, the data-parallel loss is
    the mean of the shards' mean losses (as JAX's pmean computes it), not
    the mean over the batch's valid pixels; each shard is replicated over
    `pixels`. The gap is named."""
    world, _ = dp_world
    ranks = world.ranks("uneven")
    assert [int(r["views"]) for r in ranks] == [0, 0, 1, 1]
    batch = _uneven_batch()
    tr = SegmentationTrainer(**TRAINER, device=CPU)
    with torch.no_grad():
        logits = tr.model(torch.from_numpy(batch["image"])).numpy()
    labels = batch["labels"]
    port = [float(softmax_xent_ignore(torch.from_numpy(logits[s]),
                                      torch.from_numpy(labels[s])))
            for s in (slice(0, 2), slice(2, 4), slice(0, 4))]
    jaxs = [float(jtraining.softmax_xent_ignore(jnp.asarray(logits[s]),
                                                jnp.asarray(labels[s])))
            for s in (slice(0, 2), slice(2, 4), slice(0, 4))]
    np.testing.assert_allclose(port, jaxs, rtol=1e-6)
    shard_means = (port[0] + port[1]) / 2
    batch_mean = port[2]
    assert batch_mean == pytest.approx((128 * port[0] + 32 * port[1]) / 160,
                                       rel=1e-6)
    gap = abs(shard_means - batch_mean)
    assert gap > 1e-3, (shard_means, batch_mean)
    for r in ranks:
        assert float(r["loss"]) == pytest.approx(shard_means, rel=1e-5)
        assert abs(float(r["loss"]) - batch_mean) > 0.5 * gap


# ------------------------------------------------------------------- parity

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_xent_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (2, 5, 7, 6)).astype(np.float32)
    labels = rng.integers(-1, 6, (2, 5, 7)).astype(np.int32)
    got = float(softmax_xent_ignore(torch.from_numpy(logits),
                                    torch.from_numpy(labels)))
    want = float(jtraining.softmax_xent_ignore(jnp.asarray(logits),
                                               jnp.asarray(labels)))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1.0), (got, want)


def test_xent_all_ignored_is_zero():
    logits = np.random.default_rng(0).normal(size=(1, 3, 3, 4)).astype(
        np.float32)
    labels = np.full((1, 3, 3), IGNORE_LABEL, np.int32)
    got = softmax_xent_ignore(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    assert float(got) == 0.0 and torch.isfinite(got)
    want = jtraining.softmax_xent_ignore(jnp.asarray(logits),
                                         jnp.asarray(labels))
    assert float(want) == 0.0


def test_adamw_update_matches_optax():
    """torch.optim.AdamW as the trainer builds it against optax.adamw on
    the same float32 params and gradients over three steps (gradients
    spanning six decades, so bias correction and eps both show; a weight
    decay large enough that coupled or skipped decay would show): moments
    and parameters within ~1e-7 of the tensor's scale (a few ulps)."""
    rng = np.random.default_rng(0)
    shapes = [(3, 3, 4, 8), (8,), (64,), (1, 1, 16, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    wd = 0.05
    tx = optax.adamw(LR, weight_decay=wd)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = torch.optim.AdamW(tp, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd)
    for _ in range(3):
        grads = [(rng.normal(size=s) * 10.0 ** rng.uniform(-6, 0)).astype(
            np.float32) for s in shapes]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        adam = state[0]
        for i, (want, got) in enumerate(zip(jp, tp)):
            want = np.asarray(want)
            assert np.abs(got.detach().numpy() - want).max() <= \
                3e-7 * np.abs(want).max(), i
            for mine, theirs in ((opt.state[got]["exp_avg"], adam.mu[i]),
                                 (opt.state[got]["exp_avg_sq"], adam.nu[i])):
                theirs = np.asarray(theirs)
                assert np.abs(mine.numpy() - theirs).max() <= \
                    3e-7 * np.abs(theirs).max(), i


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer (UNet(8, 16, 32), 2 classes, 32x32, lr 3e-3, seed
    0) over four steps on one batch: params before and after each step,
    the optimizer state after three, and its save after four."""
    tmp = tmp_path_factory.mktemp("jax_train")
    batch = _toy_batch(np.random.default_rng(11), 4, 32, 32, 2)
    tr = _jax_trainer(2, (32, 32), "unet", (8, 16, 32), LR, 0)
    params, losses = [_np_tree(tr.params)], []
    opt3 = None
    for step in range(4):
        if step == 3:
            opt3 = _np_tree(tr.opt_state)
        losses.append(tr.train_step(batch))
        params.append(_np_tree(tr.params))
    tr.save(str(tmp / "jax.msgpack"))
    return dict(batch=batch, params=params, losses=losses, opt3=opt3,
                save=tmp / "jax.msgpack", template=params[0])


def _port_from(tree, arch="unet", widths=(8, 16, 32)):
    tr = SegmentationTrainer(2, (32, 32), arch, widths, LR, device=CPU)
    tr.model.load_state_dict(convert.segmentation_params(tree, arch, widths))
    return tr


def test_train_step_matches_jax(jax_run):
    """One port train_step from the JAX trainer's initial params: the loss
    within LOSS_RTOL, the update within the bounds of the docstring."""
    tr = _port_from(jax_run["params"][0])
    before = _state(tr)
    loss = tr.train_step(jax_run["batch"])
    want = jax_run["losses"][0]
    assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)
    assert_update_close(before, _state(tr), jax_run["params"][0],
                        jax_run["params"][1], "unet", (8, 16, 32))


def test_flax_params_round_trip(jax_run):
    """flax_params inverts segmentation_params bit for bit, and wrong keys
    raise."""
    tree = jax_run["params"][3]
    back = convert.flax_params(
        convert.segmentation_params(tree, "unet", (8, 16, 32)), "unet",
        (8, 16, 32))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert flat_b[path].dtype == np.float32
        np.testing.assert_array_equal(flat_b[path], leaf)
    state = convert.segmentation_params(tree, "unet", (8, 16, 32))
    with pytest.raises(KeyError):
        convert.flax_params(state, "unet", (8, 16))


def test_carried_optimizer_state_steps_like_jax(jax_run):
    """Three JAX steps, then the params (flax_params round trip) and
    optax's state (adamw_state) carried into a port trainer: the moments
    equal optax's bit for bit (kernels permuted), the step count is 3,
    and one more step in each framework agrees within the bounds."""
    p3 = convert.flax_params(
        convert.segmentation_params(jax_run["params"][3], "unet",
                                    (8, 16, 32)), "unet", (8, 16, 32))
    tr = _port_from(p3)
    carried = convert.adamw_state(jax_run["opt3"], "unet", (8, 16, 32))
    state = tr.optimizer.state_dict()
    state["state"] = {
        i: dict(carried[name], **{k: torch.empty_like(p).copy_(
            carried[name][k]) for k in ("exp_avg", "exp_avg_sq")})
        for i, (name, p) in enumerate(tr.model.named_parameters())}
    tr.optimizer.load_state_dict(state)
    mu = convert.segmentation_params(jax_run["opt3"][0].mu, "unet",
                                     (8, 16, 32))
    for name, p in tr.model.named_parameters():
        st = tr.optimizer.state[p]
        assert float(st["step"]) == 3.0
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert st["exp_avg"].stride() == p.stride(), name
    before = _state(tr)
    loss = tr.train_step(jax_run["batch"])
    want = jax_run["losses"][3]
    assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)
    assert_update_close(before, _state(tr), jax_run["params"][3],
                        jax_run["params"][4], "unet", (8, 16, 32))


def test_load_flax_reads_a_jax_trainers_save(jax_run):
    tr = SegmentationTrainer(2, (32, 32), "unet", (8, 16, 32), device=CPU)
    tr.load(jax_run["save"])
    want = convert.segmentation_params(jax_run["params"][4], "unet",
                                       (8, 16, 32))
    for k, v in tr.params.items():
        assert torch.equal(v, want[k]), k


def test_flax_reads_dump_flax_bit_for_bit(jax_run, tmp_path):
    """A port trainer's save (dump_flax of flax_params) read by flax's own
    reader into the JAX trainer's template: every leaf bit for bit."""
    tr = _port_from(jax_run["params"][0])
    tr.train_step(jax_run["batch"])
    tr.save(tmp_path / "port.msgpack")
    data = (tmp_path / "port.msgpack").read_bytes()
    restored = flax_serialization.from_bytes(jax_run["template"], data)
    want = convert.flax_params(tr.params, "unet", (8, 16, 32))
    got = dict(jax.tree_util.tree_leaves_with_path(restored))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        assert np.asarray(got[path]).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)
    # and the port's reader gives back the tensors
    back = serialization.load_flax(data)
    assert torch.equal(
        back["params"]["Conv_0"]["kernel"],
        torch.from_numpy(want["params"]["Conv_0"]["kernel"]))


def test_dump_flax_writes_every_leaf_kind():
    """Maps, nested lists, the msgpack integer and size classes, float32
    and bfloat16 tensors, numpy scalars: flax's reader and load_flax agree
    with the tree."""
    rng = np.random.default_rng(4)
    tree = {"a": {"kernel": rng.random((3, 3, 2, 4), dtype=np.float32)},
            "bf16": torch.randn(5).to(torch.bfloat16),
            "ints": np.arange(70000, dtype=np.int32),
            "many": {f"k{i}": np.full(i, i, np.float32) for i in range(20)},
            "scalar": np.float32(2.5),
            "plain": [1, -5, 300, -300, 2**40, 1.5, None, True, "s" * 40]}
    data = serialization.dump_flax(tree)
    flax_tree = flax_serialization.msgpack_restore(data)
    np.testing.assert_array_equal(flax_tree["a"]["kernel"],
                                  tree["a"]["kernel"])
    np.testing.assert_array_equal(flax_tree["ints"], tree["ints"])
    assert flax_tree["scalar"] == np.float32(2.5)
    assert flax_tree["plain"] == tree["plain"]
    assert len(flax_tree["many"]) == 20
    np.testing.assert_array_equal(
        np.asarray(flax_tree["bf16"], np.float32),
        tree["bf16"].float().numpy())
    ours = serialization.load_flax(data)
    assert torch.equal(ours["bf16"], tree["bf16"])
    np.testing.assert_array_equal(ours["many"]["k7"].numpy(),
                                  tree["many"]["k7"])
    with pytest.raises(TypeError):
        serialization.dump_flax({1: np.zeros(2)})


def test_pspnet_trainer_matches_jax_forward():
    """The PSPNet trainer's first loss equals JAX's within LOSS_RTOL from
    the same params (the arch the other tests do not step)."""
    rng = np.random.default_rng(6)
    batch = _toy_batch(rng, 2, 32, 32, 3)
    widths = (8, 16, 32, 32)
    jt = _jax_trainer(3, (32, 32), "pspnet", widths, LR, 2)
    p0 = _np_tree(jt.params)
    logits = jax.jit(jt.model.apply)(jt.params, batch["image"])
    want = float(jtraining.softmax_xent_ignore(logits, batch["labels"]))
    tr = SegmentationTrainer(3, (32, 32), "pspnet", widths, LR, device=CPU)
    tr.model.load_state_dict(convert.segmentation_params(p0, "pspnet",
                                                         widths))
    loss = tr.train_step(batch)
    assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)


def test_trainer_keeps_its_own_autograd_tensors():
    """A trainer's state_dict loads into a predictor (built under
    inference_mode), and training goes on afterwards: the trainer never
    shares tensors with a predictor."""
    rng = np.random.default_rng(8)
    tr = SegmentationTrainer(2, (16, 16), "rgbd", (8, 16), device=CPU)
    predict = segmentation.load_rgbd_predictor(
        classes=2, input_hw=(16, 16), widths=(8, 16), params=tr.params,
        device=CPU)
    color = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    depth = rng.integers(0, 3000, (16, 16)).astype(np.uint16)
    probs = predict(color, depth)
    assert tuple(probs.shape) == (16, 16, 2)
    batch = _toy_batch(rng, 2, 16, 16, 2, with_depth=True)
    assert np.isfinite(tr.train_step(batch))
    assert any(not torch.equal(v, predict.params[k])
               for k, v in tr.params.items())


def test_trainer_optimizer_is_optax_adamw():
    """The trainer's optimizer has optax.adamw's hyperparameters (torch's
    AdamW defaults to weight decay 1e-2; one step cannot show 1e-4 from
    1e-2 within the update bounds), covers every parameter, and is not
    the fused implementation."""
    tr = SegmentationTrainer(2, (16, 16), "rgbd", (8, 16),
                             learning_rate=1e-3, weight_decay=2e-4,
                             device=CPU)
    assert isinstance(tr.optimizer, torch.optim.AdamW)
    (group,) = tr.optimizer.param_groups
    assert group["lr"] == 1e-3 and group["weight_decay"] == 2e-4
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert not group["fused"] and not group["amsgrad"]
    assert len(group["params"]) == len(list(tr.model.parameters()))
    assert SegmentationTrainer(2, (16, 16), "unet", (8, 16), device=CPU
                               ).optimizer.defaults["weight_decay"] == 1e-4


def test_data_parallel_step_refuses_a_mesh_of_another_device():
    class Mesh:
        device_type = "cuda"

    tr = SegmentationTrainer(2, (16, 16), "unet", (8, 16), device=CPU)
    with pytest.raises(ValueError, match="mesh on cuda"):
        make_data_parallel_step(tr, Mesh())


def test_trainer_rejects_an_unknown_arch():
    with pytest.raises(ValueError, match="unknown arch"):
        SegmentationTrainer(2, arch="vit", device=CPU)

