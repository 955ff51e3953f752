"""OneFormer3D's ScanNet instance segmentation at inference: UniDet3D's
voxelization, sparse U-Net and superpoint pooling, then a Mask2Former-style
query decoder with masked cross-attention (M1, ``ops/mask_attention.py``).

Kolodiazhnyi, Vorontsova, Konushin and Rukhovich, "OneFormer3D: One
Transformer for Unified Point Cloud Segmentation", CVPR 2024
(arXiv:2311.14405); the public config is ``configs/oneformer3d_1xb4_
scannet.py`` of github.com/filapro/oneformer3d (``ScanNetOneFormer3D``,
``ScanNetQueryDecoder``). The decoder:

  * inputs, from the (S, 32) superpoint features: keys and values
    ``input_proj`` (Linear, LayerNorm, ReLU), mask features ``x_mask``
    (Linear, ReLU, Linear), and the queries: every superpoint slot through
    ``query_proj`` (Linear, ReLU, Linear; ``num_instance_queries`` = 0) and
    the 20 learned semantic queries;
  * a prediction head before the first layer and after every layer (7 sets):
    ``norm = out_norm(q)``, class logits ``out_cls(norm)`` (18 + 1), mask
    logits ``norm . x_mask(sp)^T`` over the scene's superpoints;
  * 6 layers, post-norm, each masked cross-attention, self-attention, FFN.
    Layer l's cross-attention lets query i attend to superpoint j only where
    set l's mask logit (i, j) is >= 0 (sigmoid >= 0.5), the sign tested on
    the logit; a query whose row would be closed whole is opened whole
    (``attn_mask[where(attn_mask.sum(-1) == S)] = False``).

Departures from the public code, each kept for a reason:

  * the semantic queries come first (rows 0..19) and the superpoint queries
    after them (rows 20..20 + S), where the public code concatenates the
    superpoints first. Attention is equivariant to the order of the
    queries; this order makes the rows that hold a query a prefix of each
    padded scene, which M1's q_len bounds;
  * scenes are padded to the group's superpoint slots, as UniDet3D's are:
    padded superpoints are closed keys, and padded query rows attend to no
    key in the cross-attention (M1 gives them zeros) and to each other only
    in the self-attention (K3's segment ids), so they change no valid row;
  * the self-attention and the FFN are UniDet3D's port's layers
    (``decoder.py::SelfAttentionLayer`` and ``FFN``, and so K3): GELU is the
    tanh approximation and every LayerNorm's eps is 1e-6, where the public
    code uses the exact GELU and eps 1e-5. Linear layers compute in the
    configuration's dtype (bf16), mask logits take bf16 operands and fp32
    sums, and M1 rounds p to bf16 before the p v product, as K3;
  * ``objectness_flag`` is False in the public config, so no score branch is
    built; ``out_sem`` (per-query semantic logits, read only by the
    panoptic output and the losses) is not built either;
  * the panoptic output (``pan_score_thr``, ``stuff_classes``) is out of
    scope: the model gives instances and a semantic map;
  * the superpoint cap is UniDet3D's 3,072 slots per scene (the public code
    has no cap); the harness configuration lists it under ``assumed``.

``forward`` returns (OneFormer3DOutput, OneFormer3DAux); the post-processing
(top-k, object normalization, matrix NMS, thresholds) is
``models/instance_postprocess.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import OneFormer3DConfig
from ..device import resolve_device
from ..ops.mask_attention import mask_attention_cuda, pack_bits
from ..train.profiling import span
from .decoder import FFN, LN_EPS, SelfAttentionLayer, linear
from .detector import DTYPES, GridPack, PointBatch, pool_superpoints, voxel_features
from .unet import UNetBackbone


class OneFormer3DOutput(NamedTuple):
    """cls_logits: (L, B, Q, C + 1) class logits of every query in each of
    the L = num_layers + 1 prediction sets; masks: (B, Q, S) fp32 mask
    logits of the last set. Rows 0..n_sem - 1 are the semantic queries,
    row n_sem + j the query of superpoint slot j."""

    cls_logits: torch.Tensor
    masks: torch.Tensor


class OneFormer3DAux(NamedTuple):
    sp_valid: torch.Tensor  # (B, S) superpoint slots holding points
    sp_counts: torch.Tensor  # (B, S) valid points per slot, fp32
    query_valid: torch.Tensor  # (B, Q)
    attn_bits: tuple  # per layer, the (B, Q, ceil(S / 32)) int32 bits M1 read
    open_pairs: torch.Tensor  # (num_layers,) int64: open (query, key) pairs of valid rows


def attention_bits(mask_logits: torch.Tensor, key_valid: torch.Tensor,
                   query_valid: torch.Tensor):
    """The cross-attention mask of the next layer from a set's mask logits:
    (packed bits, open pairs of valid rows). Bit (i, j) is open where the
    logit is >= 0 and key j is valid; a valid row with no open key is opened
    to every valid key; invalid rows stay closed."""
    open_ = (mask_logits >= 0) & key_valid[:, None, :] & query_valid[:, :, None]
    n_open = open_.sum(-1)
    closed = (n_open == 0) & query_valid
    open_ = open_ | (closed[:, :, None] & key_valid[:, None, :])
    n_open = torch.where(closed, key_valid.sum(-1, keepdim=True), n_open)
    return pack_bits(open_), n_open.sum()


class MaskCrossAttention(nn.Module):
    """Post-norm masked multi-head cross-attention (the public
    ``CrossAttentionLayer`` with ``fix=True``): queries over the scene's
    projected superpoint features, through M1."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, src, bits, q_len, k_len):
        b, lq, d = x.shape
        h = self.num_heads
        hd = d // h

        def heads(inp, layer):
            y = linear(inp, layer, self.dtype).view(b, inp.shape[1], h, hd)
            return y.transpose(1, 2).contiguous()

        o = mask_attention_cuda(heads(x, self.query), heads(src, self.key),
                                heads(src, self.value), bits, q_len, k_len,
                                1.0 / (hd ** 0.5))
        z = linear(o.transpose(1, 2).reshape(b, lq, d), self.out, self.dtype).float()
        return self.norm(z + x)


class MaskQueryDecoder(nn.Module):
    """OneFormer3D's ScanNet query decoder (module docstring)."""

    def __init__(self, in_channels: int, num_layers: int, d_model: int, num_heads: int,
                 hidden_dim: int, activation: str, num_semantic_queries: int,
                 num_classes: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        self.n_sem = num_semantic_queries
        self.input_fc = nn.Linear(in_channels, d_model)
        self.input_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.query_fc1 = nn.Linear(in_channels, d_model)
        self.query_fc2 = nn.Linear(d_model, d_model)
        self.sem_query = nn.Parameter(torch.zeros(num_semantic_queries, d_model))
        self.x_mask_fc1 = nn.Linear(in_channels, d_model)
        self.x_mask_fc2 = nn.Linear(d_model, d_model)
        self.out_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cls_fc1 = nn.Linear(d_model, d_model)
        self.cls_fc2 = nn.Linear(d_model, num_classes + 1)
        for i in range(num_layers):
            self.add_module(f"cross{i}", MaskCrossAttention(d_model, num_heads, dtype))
            self.add_module(f"attn{i}", SelfAttentionLayer(d_model, num_heads, dtype))
            self.add_module(f"ffn{i}", FFN(d_model, hidden_dim, activation, dtype))

    def _head(self, x, mask_feats):
        """(class logits (B, Q, C + 1), mask logits (B, Q, S) fp32)."""
        dt = self.dtype
        h = self.out_norm(x)
        cls = linear(F.relu(linear(h, self.cls_fc1, dt)), self.cls_fc2, dt).float()
        masks = h.to(dt).float() @ mask_feats.to(dt).float().transpose(1, 2)
        return cls, masks

    def forward(self, sp_feats: torch.Tensor, sp_valid: torch.Tensor):
        """sp_feats (B, S, C_in), sp_valid (B, S) -> (OneFormer3DOutput, per
        layer bits, per layer open pairs, query_valid)."""
        dt = self.dtype
        b, s, _ = sp_feats.shape
        src = F.relu(self.input_norm(linear(sp_feats, self.input_fc, dt).float()))
        mask_feats = linear(F.relu(linear(sp_feats, self.x_mask_fc1, dt)), self.x_mask_fc2, dt)
        inst = linear(F.relu(linear(sp_feats, self.query_fc1, dt)), self.query_fc2, dt).float()
        x = torch.cat([self.sem_query.float()[None].expand(b, -1, -1), inst], dim=1)
        query_valid = torch.cat([sp_valid.new_ones((b, self.n_sem)), sp_valid], dim=1)
        seg = torch.where(query_valid, 1, 2).to(torch.int32).contiguous()
        # Keys worth visiting and rows holding a query: up to the last valid slot.
        slots = torch.arange(1, s + 1, device=sp_valid.device, dtype=torch.int32)
        k_len = torch.where(sp_valid, slots, 0).amax(1).to(torch.int32)
        q_len = (k_len + self.n_sem).to(torch.int32)

        cls, masks = self._head(x, mask_feats)
        cls_list, bits_list, pairs = [cls], [], []
        for i in range(self.num_layers):
            bits, n_open = attention_bits(masks, sp_valid, query_valid)
            bits_list.append(bits)
            pairs.append(n_open)
            x = getattr(self, f"cross{i}")(x, src, bits, q_len, k_len)
            x = getattr(self, f"attn{i}")(x, seg)
            x = getattr(self, f"ffn{i}")(x)
            cls, masks = self._head(x, mask_feats)
            cls_list.append(cls)
        out = OneFormer3DOutput(cls_logits=torch.stack(cls_list), masks=masks)
        return out, tuple(bits_list), torch.stack(pairs), query_valid


class OneFormer3D(nn.Module):
    """Backbone + mask decoder; ``forward(batch, pack)`` returns
    (OneFormer3DOutput, OneFormer3DAux), at inference only (eval BN, no
    graph: callers run it under ``torch.no_grad()``). Parameters live on
    `device`; the weights are zeros until ``weights.seeded_init_`` or a
    state dict fills them."""

    def __init__(self, cfg: OneFormer3DConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dtype = DTYPES[cfg.compute_dtype]
        self.backbone = UNetBackbone(cfg.in_channels, cfg.num_planes, dtype)
        self.decoder = MaskQueryDecoder(
            in_channels=cfg.num_planes[0], num_layers=cfg.num_layers, d_model=cfg.d_model,
            num_heads=cfg.num_heads, hidden_dim=cfg.hidden_dim, activation=cfg.activation,
            num_semantic_queries=cfg.num_semantic_queries,
            num_classes=cfg.num_instance_classes, dtype=dtype)
        self.to(device)
        self.eval()

    def forward(self, batch: PointBatch, pack: GridPack | None):
        """batch and pack as ``UniDet3D.forward`` takes them (pack None: the
        rulebooks are built on the device)."""
        s = self.cfg.max_superpoints
        pack, pinv, vox_feats = voxel_features(self.cfg, batch, pack)
        feats = self.backbone(vox_feats, pack, False)
        _, sp_feats, sp_counts = pool_superpoints(feats, pinv, batch, s)
        sp_valid = sp_counts > 0
        with span("eval.decoder"):
            out, bits, pairs, query_valid = self.decoder(sp_feats, sp_valid)
        return out, OneFormer3DAux(sp_valid=sp_valid, sp_counts=sp_counts,
                                   query_valid=query_valid, attn_bits=bits, open_pairs=pairs)
