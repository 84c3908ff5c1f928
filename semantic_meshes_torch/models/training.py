"""Training for the bundled segmentation models, on PyTorch.

Counterpart of the JAX package's `semantic_meshes/models/training.py`
(flax + optax): the same loss (`softmax_xent_ignore`, labels of -1
ignored), the same `SegmentationTrainer` (AdamW over every parameter,
bf16 convolutions with float32 parameters and optimizer state), and the
same data-parallel step, over a `torch.distributed` DeviceMesh instead of
`shard_map`. Weights are written and read as flax msgpack
(`serialization.dump_flax` / `load_flax` through
`convert.flax_params` / `segmentation_params`), so a file of either
package loads in the other's trainer and predictors.

The optimizer is `torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8,
weight_decay)`, optax's `adamw` arithmetic (bias-corrected moments, eps
outside the square root, decay decoupled and applied to the old
parameters) rounded in another order; optax's `adamw` has no mask here,
so biases and GroupNorm parameters decay too. The fused optimizer is not
used: it rounds differently again. cuDNN's TF32 stays off for the whole
step (forward, backward and update), so the float32 head's gradients are
float32 on the card as on the CPU (`segmentation._ieee_f32` alone covers
only the forward). There is no backward kernel of the JAX package to
port: its gradients are XLA's, here autograd's.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..data import resolve_device
from . import segmentation
from .serialization import dump_flax, load_flax

IGNORE_LABEL = -1


def softmax_xent_ignore(logits, labels):
    """Mean cross entropy over the pixels whose label is >= 0 (ignore =
    -1), log_softmax in float32, divided by max(count, 1): a batch with
    no valid pixel gives 0."""
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).to(torch.int64)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def _batch_tensor(a, device, dtype):
    """A batch array (numpy or tensor) as a contiguous tensor on device."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device, dtype=dtype)


class SegmentationTrainer:
    """Minimal trainer: AdamW + cross-entropy with ignore labels.

    arch: "unet" | "pspnet" (RGB) or "rgbd" (RGB-D). The model is
    `segmentation.ARCHS[arch](classes, widths)` with flax's
    initialisation from `seed` (`segmentation.init_`), on `device`
    (default "cuda", raising without a card) in channels_last. input_hw
    is kept for parity: the port's models need no input to initialise.
    `.model`, `.optimizer` and `.params` (the model's state_dict) are the
    trainer's state; the JAX package keeps params and opt_state as trees.
    """

    def __init__(self, classes, input_hw=(256, 256), arch="unet",
                 widths=(32, 64, 128, 256), learning_rate=3e-4,
                 weight_decay=1e-4, seed=0, device="cuda"):
        if arch not in segmentation.ARCHS:
            raise ValueError(f"unknown arch {arch!r}; expected one of "
                             f"{tuple(segmentation.ARCHS)}")
        self.classes = int(classes)
        self.input_hw = tuple(input_hw)
        self.arch = arch
        self.widths = tuple(widths)
        self.device = resolve_device(device)
        model = segmentation.ARCHS[arch](classes=self.classes,
                                         widths=self.widths)
        self.model = segmentation.init_(model, seed).to(self.device).to(
            memory_format=torch.channels_last)
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=weight_decay)

    @property
    def params(self):
        return self.model.state_dict()

    def _forward(self, batch):
        image = _batch_tensor(batch["image"], self.device, torch.float32)
        if self.arch == "rgbd":
            depth = _batch_tensor(batch["depth"], self.device, torch.float32)
            return self.model(image, depth)
        return self.model(image)

    def _backward(self, batch):
        """Loss of `batch` (a detached scalar tensor); its gradients in
        each parameter's .grad. Call with TF32 off."""
        self.optimizer.zero_grad(set_to_none=True)
        labels = _batch_tensor(batch["labels"], self.device, torch.int64)
        loss = softmax_xent_ignore(self._forward(batch), labels)
        loss.backward()
        return loss.detach()

    def train_step(self, batch):
        """batch: image (B, H, W, 3) float32 in [0, 1], labels (B, H, W)
        int32 (-1 ignore), depth (B, H, W, 1) for "rgbd"; numpy arrays or
        tensors. One AdamW step; returns the loss as a float."""
        with segmentation._ieee_f32():
            loss = self._backward(batch)
            self.optimizer.step()
        return float(loss)

    def predict_logits(self, images):
        if self.arch == "rgbd":
            raise ValueError("use predict_logits_rgbd for rgbd models")
        with torch.no_grad():
            return self._forward({"image": images})

    def save(self, path):
        """The parameters as flax msgpack (the JAX trainer's file)."""
        tree = convert.flax_params(self.params, self.arch, self.widths)
        with open(path, "wb") as f:
            f.write(dump_flax(tree))

    def load(self, path):
        """Parameters from a flax msgpack file (of either package); the
        optimizer state stays, as in the JAX trainer."""
        with open(path, "rb") as f:
            tree = load_flax(f.read())
        self.model.load_state_dict(
            convert.segmentation_params(tree, self.arch, self.widths))


def make_data_parallel_step(trainer, mesh, axis="views"):
    """Data parallelism over the DeviceMesh dimension `axis`
    (distributed.make_device_mesh): every rank calls the returned
    `step(batch) -> loss` with the same global batch; each uploads its
    contiguous block of B / size images (as make_sharded_fuse splits
    views), computes its loss and gradients, and one all-reduce of a flat
    bucket (the gradients and the loss) over `axis` averages them; then
    every rank takes the same AdamW step. Parameters and optimizer state
    stay in the trainer (the JAX package passes them in and out).

    As the JAX package's `pmean`, the loss and gradients are the mean of
    the shards' means, not the mean over all valid pixels: with uneven
    ignore labels across shards pixels weigh unequally (a known fault of
    the reference, mirrored). NCCL on cards, gloo with device="cpu"."""
    from ..distributed import MeshAxis

    if mesh.device_type != trainer.device.type:
        raise ValueError(f"mesh on {mesh.device_type}, trainer on "
                         f"{trainer.device}")
    group = MeshAxis(mesh, (axis,))
    n, rank = group.size, mesh.get_local_rank(axis)
    params = list(trainer.model.parameters())

    def step(batch):
        B = len(batch["labels"])
        if B % n:
            raise ValueError(f"batch of {B} does not split over {n} "
                             f"ranks of {axis!r}")
        lo, hi = rank * (B // n), (rank + 1) * (B // n)
        shard = {k: v[lo:hi] for k, v in batch.items()}
        with segmentation._ieee_f32():
            loss = trainer._backward(shard)
            flat = torch.cat([p.grad.reshape(-1) for p in params]
                             + [loss.reshape(1)])
            flat = group.all_reduce(flat) / n
            offset = 0
            for p in params:
                p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
                offset += p.numel()
            trainer.optimizer.step()
        return float(flat[-1])

    return step
