"""Convert a reference checkpoint (``unidet3d.pth``) into a state dict of the
port's ``models.detector.UniDet3D``.

The port's own copy of the JAX package's key map (its
``tools/convert_checkpoint.py``), writing the port's names directly. It covers
every parameter and running statistic of the reference model: ``input_conv``
/ ``output_layer``, the recursive SpConvUNet (``blocks`` / ``conv`` / ``u`` /
``deconv`` / ``blocks_tail``), and the decoder (``input_proj``, self-attention,
FFN, norms, the unified class head, the box head).

Layouts:
  * spconv conv weights are stored (Cout, k, k, k, Cin) or (k, k, k, Cin,
    Cout), told apart by shape; both become (k^3, Cin, Cout) with x-major
    offsets; a 1x1x1 ``i_branch`` becomes a (Cin, Cout) matrix;
  * ``nn.Linear`` weights keep their (out, in) layout;
  * ``nn.MultiheadAttention``'s ``in_proj`` (3d, d) splits into the query,
    key and value weights (d, d), its bias into three (d,);
  * BN / LayerNorm ``weight`` / ``bias`` and BN running statistics keep
    their names.

Real checkpoints differ from synthetic ones in key names alone: a uniform
``module.`` / ``model.`` wrapper prefix is stripped, ``num_batches_tracked``
buffers are ignored, a key the conversion does not consume is reported, and a
missing key raises a KeyError naming the closest keys in the file.

Usage:
  python -m unidet3d_tpu_torch.tools.convert_checkpoint unidet3d.pth out.pth \\
      [--planes 32 64 96 128 160] [--d-model 256] [--heads 8] [--layers 6]

The output is read by ``train.checkpoint.restore_params`` (``load_from``).
"""
from __future__ import annotations

import argparse
import difflib

import numpy as np
import torch

# Buffers of the reference's BN state with no counterpart in the port.
_IGNORED_SUFFIXES = (".num_batches_tracked",)
# DDP / EMA wrapper prefixes seen in real .pth files.
_WRAPPER_PREFIXES = ("module.", "model.")


def normalize_state_dict(sd: dict) -> dict:
    """Strip a uniform DDP / EMA wrapper prefix (``module.`` / ``model.``)
    when every key carries it."""
    keys = list(sd.keys())
    for pre in _WRAPPER_PREFIXES:
        if keys and all(k.startswith(pre) for k in keys):
            return {k[len(pre):]: v for k, v in sd.items()}
    return sd


class _TrackedDict(dict):
    """Records which keys the conversion consumed, and turns a miss into a
    report naming the closest keys present."""

    def __init__(self, sd: dict):
        super().__init__(sd)
        self.consumed: set = set()

    def __getitem__(self, k):
        try:
            v = super().__getitem__(k)
        except KeyError:
            close = difflib.get_close_matches(k, self.keys(), n=3, cutoff=0.4)
            raise KeyError(
                f"checkpoint is missing expected key {k!r}"
                + (f"; closest present keys: {close}" if close else
                   "; no similar keys present — wrong architecture flags "
                   "(--planes/--layers) or not a unidet3d checkpoint?")
            ) from None
        self.consumed.add(k)
        return v

    def unexpected(self) -> list:
        return sorted(
            k for k in self.keys()
            if k not in self.consumed and not k.endswith(_IGNORED_SUFFIXES)
        )


def _conv_kernel(w: np.ndarray, k: int) -> np.ndarray:
    """spconv weight -> (k^3, Cin, Cout), x-major offset order."""
    w = np.asarray(w)
    if w.ndim != 5:
        raise ValueError(f"unexpected conv weight shape {w.shape}")
    if w.shape[1] == k and w.shape[2] == k and w.shape[3] == k:
        w = np.transpose(w, (1, 2, 3, 4, 0))  # (Cout, k, k, k, Cin) -> (k, k, k, Cin, Cout)
    elif not (w.shape[0] == k and w.shape[1] == k and w.shape[2] == k):
        raise ValueError(f"unexpected conv weight shape {w.shape}")
    return w.reshape(k**3, w.shape[3], w.shape[4])


def _norm(out: dict, sd, src: str, dst: str, stats: bool = True) -> None:
    for leaf in ("weight", "bias") + (("running_mean", "running_var") if stats else ()):
        out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"]


def _linear(out: dict, sd, src: str, dst: str) -> None:
    out[f"{dst}.weight"] = sd[f"{src}.weight"]
    out[f"{dst}.bias"] = sd[f"{src}.bias"]


def _residual_block(out: dict, sd, src: str, dst: str) -> None:
    _norm(out, sd, f"{src}.conv_branch.0", f"{dst}.norm1")
    out[f"{dst}.conv1.weight"] = _conv_kernel(sd[f"{src}.conv_branch.2.weight"], 3)
    _norm(out, sd, f"{src}.conv_branch.3", f"{dst}.norm2")
    out[f"{dst}.conv2.weight"] = _conv_kernel(sd[f"{src}.conv_branch.5.weight"], 3)
    ib = f"{src}.i_branch.0.weight"
    if ib in sd:
        w = np.asarray(sd[ib])
        out[f"{dst}.i_branch"] = _conv_kernel(w, 1)[0] if w.ndim == 5 else w


def convert_state_dict(sd: dict, num_levels: int = 5, num_layers: int = 6,
                       d_model: int = 256, report: dict | None = None) -> dict:
    """Reference state dict (torch tensors or numpy) -> the port's state
    dict (float32 CPU tensors). `report`, when given, receives
    {"unexpected": [keys not consumed], "consumed": count}."""
    sd = _TrackedDict({k: np.asarray(v, np.float32)
                       for k, v in normalize_state_dict(sd).items()})
    out: dict = {}
    out["backbone.input_conv.weight"] = _conv_kernel(sd["input_conv.0.weight"], 3)
    _norm(out, sd, "output_layer.0", "backbone.output_norm")
    for lvl in range(num_levels):
        u = "unet." + "u." * lvl
        dst = f"backbone.unet.level{lvl}"
        for i in range(2):
            _residual_block(out, sd, f"{u}blocks.block{i}", f"{dst}_block{i}")
        if lvl < num_levels - 1:
            _norm(out, sd, f"{u}conv.0", f"{dst}_down_norm")
            out[f"{dst}_down_kernel"] = _conv_kernel(sd[f"{u}conv.2.weight"], 2)
            _norm(out, sd, f"{u}deconv.0", f"{dst}_up_norm")
            out[f"{dst}_up_kernel"] = _conv_kernel(sd[f"{u}deconv.2.weight"], 2)
            for i in range(2):
                _residual_block(out, sd, f"{u}blocks_tail.block{i}", f"{dst}_tail{i}")

    _linear(out, sd, "decoder.input_proj.0", "decoder.proj_fc1")
    _linear(out, sd, "decoder.input_proj.2", "decoder.proj_fc2")
    for i in range(num_layers):
        src, dst = f"decoder.self_attn_layers.{i}", f"decoder.attn{i}"
        in_w = sd[f"{src}.attn.in_proj_weight"]  # (3d, d): query, key, value rows
        in_b = sd[f"{src}.attn.in_proj_bias"]
        if in_w.shape != (3 * d_model, d_model):
            raise ValueError(f"{src}.attn.in_proj_weight {in_w.shape}: not d_model {d_model}")
        for j, name in enumerate(("query", "key", "value")):
            out[f"{dst}.attn.{name}.weight"] = in_w[j * d_model:(j + 1) * d_model]
            out[f"{dst}.attn.{name}.bias"] = in_b[j * d_model:(j + 1) * d_model]
        _linear(out, sd, f"{src}.attn.out_proj", f"{dst}.attn.out")
        _norm(out, sd, f"{src}.norm", f"{dst}.norm", stats=False)
        src, dst = f"decoder.ffn_layers.{i}", f"decoder.ffn{i}"
        _linear(out, sd, f"{src}.net.0", f"{dst}.fc1")
        _linear(out, sd, f"{src}.net.3", f"{dst}.fc2")
        _norm(out, sd, f"{src}.norm", f"{dst}.norm", stats=False)
    _norm(out, sd, "decoder.out_norm", "decoder.out_norm", stats=False)
    _linear(out, sd, "decoder.outs_cls.0", "decoder.cls_fc1")
    _linear(out, sd, "decoder.outs_cls.2", "decoder.cls_fc2")
    _linear(out, sd, "decoder.out_bboxes.linear", "decoder.box_fc")
    if report is not None:
        report["unexpected"] = sd.unexpected()
        report["consumed"] = len(sd.consumed)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Convert a reference unidet3d.pth for the port")
    ap.add_argument("checkpoint", help="reference .pth file (a state dict, or a dict "
                    "holding one under 'state_dict')")
    ap.add_argument("out", help="output .pth (a state dict for load_from)")
    ap.add_argument("--planes", type=int, nargs="+", default=[32, 64, 96, 128, 160])
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--layers", type=int, default=6)
    args = ap.parse_args(argv)
    if args.d_model % args.heads:
        raise ValueError(f"--d-model {args.d_model} is not a multiple of --heads {args.heads}")

    from ..train.checkpoint import save_params

    # weights_only: the file comes from outside the program; tensors and
    # plain containers only.
    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    report: dict = {}
    out = convert_state_dict(sd, num_levels=len(args.planes), num_layers=args.layers,
                             d_model=args.d_model, report=report)
    save_params(args.out, out)
    print(f"converted {report.get('consumed', len(sd))} tensors -> {args.out}")
    if report.get("unexpected"):
        print(f"WARNING: {len(report['unexpected'])} checkpoint keys were "
              "not consumed by the conversion (unknown to this "
              "architecture):")
        for k in report["unexpected"]:
            print(f"  - {k}")
    return out


if __name__ == "__main__":
    main()
