"""CLEVR feature extractors: real checkpoints when present, seeded
stand-ins otherwise (port of `graphax/data/extractors.py`).

The reference precomputes CLEVR image features with a torchvision ResNet-101
trunk (conv4 / layer3 output, 14x14x1024) and question features with BERT
token embeddings (`src/data_multi.py:201-284`). No torchvision is assumed,
so:

- ``ImageFeatureExtractor`` runs the ResNet-101 trunk (`resnet_trunk`:
  NCHW ``F.conv2d`` on the torchvision state-dict layout, NHWC out) from a
  torchvision-format ``.pth`` state dict (``resnet101-*.pth``) staged under
  the data dir, on the card unless asked otherwise. Without a checkpoint
  it falls back to graphax's seeded random patch projection (numpy, so the
  arrays equal graphax's).
- ``TextFeatureExtractor`` loads a local HuggingFace checkpoint directory
  through ``transformers`` (``local_files_only=True``, imported only on
  that route) and uses its token embedding table; otherwise graphax's
  seeded random vocabulary table.

Both produce the shapes the multimodal pipeline consumes."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# torchvision resnet101: blocks per stage; CLEVR uses the layer3 output
RESNET101_STAGES = (3, 4, 23, 3)


def _conv(x, w, stride=1):
    """NCHW conv with torch OIHW weights, torch padding (k // 2)."""
    return F.conv2d(x, w, stride=stride, padding=w.shape[2] // 2)


def _bn(x, params, prefix, eps=1e-5):
    """Inference batch-norm from the running statistics, graphax's
    arithmetic: ``x * inv + (b - m * inv)`` with ``inv = g / sqrt(v +
    eps)``."""
    g = params[prefix + ".weight"]
    b = params[prefix + ".bias"]
    m = params[prefix + ".running_mean"]
    v = params[prefix + ".running_var"]
    inv = g / torch.sqrt(v + eps)
    return x * inv[:, None, None] + (b - m * inv)[:, None, None]


def _bottleneck(x, params, prefix, stride):
    out = torch.relu(_bn(_conv(x, params[prefix + ".conv1.weight"]),
                         params, prefix + ".bn1"))
    out = torch.relu(_bn(_conv(out, params[prefix + ".conv2.weight"],
                               stride), params, prefix + ".bn2"))
    out = _bn(_conv(out, params[prefix + ".conv3.weight"]), params,
              prefix + ".bn3")
    if (prefix + ".downsample.0.weight") in params:
        sc = _bn(_conv(x, params[prefix + ".downsample.0.weight"], stride),
                 params, prefix + ".downsample.1")
    else:
        sc = x
    return torch.relu(out + sc)


def resnet_trunk(x, params, stages=RESNET101_STAGES, out_stage=3):
    """Forward the torchvision-resnet trunk through ``out_stage`` stages.

    x: ``[B, H, W, 3]`` float32 tensor (ImageNet-normalised); ``params``:
    the state dict's tensors by name (numpy arrays are moved to x's
    device). Returns NHWC features: for a 224x224 input and out_stage=3,
    ``[B, 14, 14, 1024]``, the reference's CLEVR patch layout
    (`src/data_multi.py:201`)."""
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=x.device)
              for k, v in params.items()}
    out = _conv(x.permute(0, 3, 1, 2), params["conv1.weight"], 2)
    out = torch.relu(_bn(out, params, "bn1"))
    out = F.max_pool2d(out, 3, 2, 1)        # torch MaxPool2d(3, 2, 1)
    for s in range(out_stage):
        for i in range(stages[s]):
            stride = 2 if (s > 0 and i == 0) else 1
            out = _bottleneck(out, params, f"layer{s + 1}.{i}", stride)
    return out.permute(0, 2, 3, 1)


def load_torch_state_dict(path: str) -> dict:
    """Load a torch ``.pth`` state dict into a name -> np.ndarray dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: np.asarray(v.detach().cpu().numpy(), np.float32)
            for k, v in sd.items() if hasattr(v, "detach")}


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def find_resnet_checkpoint(data_dir: str) -> Optional[str]:
    for cand_dir in (os.path.join(data_dir, "checkpoints"), data_dir):
        if not os.path.isdir(cand_dir):
            continue
        for f in sorted(os.listdir(cand_dir)):
            if f.startswith("resnet101") and f.endswith(".pth"):
                return os.path.join(cand_dir, f)
    return None


class ImageFeatureExtractor:
    """ResNet-101 layer3 patch features when a checkpoint is staged (the
    trunk on ``device``, the card unless asked otherwise), a seeded random
    projection otherwise. Output: ``[B, grid^2, feat_dim]`` numpy f32."""

    def __init__(self, feat_dim: int, grid: int = 14,
                 data_dir: Optional[str] = None,
                 checkpoint: Optional[str] = None, seed: int = 0,
                 device=None):
        self.feat_dim = feat_dim
        self.grid = grid
        self.seed = seed
        self.device = device
        if checkpoint is None and data_dir is not None:
            checkpoint = find_resnet_checkpoint(data_dir)
        self.checkpoint = checkpoint
        self._params = None
        self._proj = None

    @property
    def using_real_weights(self) -> bool:
        return self.checkpoint is not None

    def _resnet_params(self, device):
        if self._params is None:
            self._params = {
                k: torch.as_tensor(v, device=device)
                for k, v in load_torch_state_dict(self.checkpoint).items()}
        return self._params

    def __call__(self, raw_imgs: np.ndarray) -> np.ndarray:
        """raw_imgs: ``[B, H, W, 3]`` in [0, 1]."""
        if self.checkpoint is not None:
            from graphax_torch.utils.device import resolve_device

            dev = resolve_device(self.device)
            x = torch.as_tensor((np.asarray(raw_imgs, np.float32)
                                 - IMAGENET_MEAN) / IMAGENET_STD,
                                device=dev)
            with torch.no_grad():
                feats = resnet_trunk(x, self._resnet_params(dev))
            b, gh, gw, c = feats.shape
            feats = feats.reshape(b, gh * gw, c).cpu().numpy()
            if c == self.feat_dim:
                return feats
            # match the configured feature width with a fixed projection
            rng = np.random.RandomState(self.seed)
            proj = rng.randn(c, self.feat_dim).astype(np.float32) / np.sqrt(c)
            return feats @ proj
        # seeded stand-in: random-projected raw patches
        rng = np.random.RandomState(self.seed)
        if self._proj is None:
            c = raw_imgs.shape[-1]
            self._proj = rng.randn(c, self.feat_dim).astype(np.float32) \
                / np.sqrt(c)
        b = raw_imgs.shape[0]
        return (raw_imgs @ self._proj).reshape(b, -1, self.feat_dim)


def find_text_checkpoint(data_dir: str) -> Optional[str]:
    for sub in ("checkpoints/bert", "bert", "checkpoints/text"):
        cand = os.path.join(data_dir, sub)
        if os.path.isdir(cand) and os.path.exists(
                os.path.join(cand, "config.json")):
            return cand
    return None


class TextFeatureExtractor:
    """BERT token embeddings from a staged HuggingFace checkpoint dir, a
    seeded random vocabulary table otherwise. Output: ``[B, L, text_dim]``
    numpy f32."""

    def __init__(self, text_dim: int, vocab_size: int = 100,
                 data_dir: Optional[str] = None,
                 checkpoint: Optional[str] = None, seed: int = 0):
        self.text_dim = text_dim
        self.vocab_size = vocab_size
        self.seed = seed
        if checkpoint is None and data_dir is not None:
            checkpoint = find_text_checkpoint(data_dir)
        self.checkpoint = checkpoint
        self._table = None

    @property
    def using_real_weights(self) -> bool:
        return self.checkpoint is not None

    def _embedding_table(self) -> np.ndarray:
        if self._table is not None:
            return self._table
        if self.checkpoint is not None:
            from transformers import AutoModel

            model = AutoModel.from_pretrained(self.checkpoint,
                                              local_files_only=True)
            emb = model.get_input_embeddings().weight
            table = emb.detach().cpu().numpy().astype(np.float32)
            if table.shape[1] != self.text_dim:
                rng = np.random.RandomState(self.seed)
                proj = rng.randn(table.shape[1], self.text_dim) \
                    .astype(np.float32) / np.sqrt(table.shape[1])
                table = table @ proj
        else:
            rng = np.random.RandomState(self.seed)
            table = rng.randn(self.vocab_size, self.text_dim) \
                .astype(np.float32)
        self._table = table
        return table

    def __call__(self, token_ids: np.ndarray) -> np.ndarray:
        table = self._embedding_table()
        return table[np.clip(token_ids, 0, table.shape[0] - 1)]
