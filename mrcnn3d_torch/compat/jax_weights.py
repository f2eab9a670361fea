"""JAX variables -> port state_dict (the weight bridge).

Takes the JAX package's `{"params", "batch_stats"}` tree as nested dicts
of numpy arrays and returns the port's state_dict under the reference
mmdet names.  Each transform is the inverse of one in
`mrcnn3d/compat/torch_convert.py`:

  flax conv kernel (kd, kh, kw, I, O)     -> torch (O, I, kd, kh, kw)
  flax deconv kernel (kd, kh, kw, I, O),
    spatially flipped                     -> torch (I, O, kd, kh, kw)
  flax dense kernel (in, out)             -> torch (out, in)
  first fc after the RoI flatten: input
    order D*H*W*C                         -> C*D*H*W
  FrozenBatchNorm scale / bias / mean / var
                                          -> weight / bias / running_*

The backbone's names: ResNet3D's and ResNeXt3D's `layer{i}_{j}` blocks
become `backbone.layer{i}.{j}` (conv1-2 of a basic block, conv1-3 of a
bottleneck; flax's grouped kernel (k, k, k, I/groups, O) takes the same
transpose as a plain one); UNet3D's `enc{i}_conv{j}`, `dec{i}_conv{j}`
keep their names.

The heads' names follow the model's kind.  The JAX package numbers its
heads `bbox_head_{i}` / `mask_head_{i}` by scale in the two-stage types
(port `bbox_head`, `bbox_head_2`, ...) but by stage in a cascade (port
`bbox_head.{i}`, `mask_head.{i}` with `conv_res.conv`, mmdet v0.6.0's
HTC names); a cascade's heads are the only class-agnostic ones (fc_reg
of 6 outputs), which is how the two are told apart.  RetinaNet's
`rpn_head_0` (a RetinaHead3D: cls_conv_i, reg_conv_i, retina_cls,
retina_reg) becomes `bbox_head.cls_convs.{i}.conv`, `.reg_convs.{i}.conv`,
`.retina_cls`, `.retina_reg`; HTC's `semantic_head` (lateral_i, conv_i,
conv_embedding, conv_logits) `semantic_head.lateral_convs.{i}.conv`,
`.convs.{i}.conv`, `.conv_embedding.conv`, `.conv_logits`.

The first fc's input order depends on the bbox RoIAlign's output shape:
`roi_shape(cfg)` reads it from the config ((1, 7, 7) for the 2-D
family, whose mask heads' (1, 2, 2) deconv takes the same transform).

Every transform is a permutation, so the same function carries any tree
shaped as the params (a gradient, optax's momentum trace) onto the
port's names; without "batch_stats" it gives the parameters only.
`load_train_state` carries a whole JAX train state across.
"""
from __future__ import annotations

import numpy as np
import torch


def _conv(w):
    return np.transpose(np.asarray(w), (4, 3, 0, 1, 2))


def _deconv(w):
    w = np.asarray(w)[::-1, ::-1, ::-1]
    return np.transpose(w, (3, 4, 0, 1, 2))


def _fc(w):
    return np.transpose(np.asarray(w))


def _fc0(w, roi_shape):
    """(D*H*W*C, out) -> (out, C*D*H*W)."""
    w = np.asarray(w)
    d, h, ww = roi_shape
    out = w.shape[1]
    c = w.shape[0] // (d * h * ww)
    w = np.transpose(w).reshape(out, d, h, ww, c)
    return np.transpose(w, (0, 4, 1, 2, 3)).reshape(out, -1)


def roi_shape(cfg):
    """The bbox RoIAlign's output (D, H, W) of cfg.model (the flagship's
    (3, 7, 7) when the config names no bbox extractor)."""
    layer = cfg.model.get("bbox_roi_extractor", {}).get("roi_layer", {})
    out = layer.get("out_size", 7)
    return (layer.get("out_size_depth", 3), out, out)


def state_dict_from_jax(variables, roi_shape=(3, 7, 7)):
    """variables: {"params": ..., "batch_stats": ...} nested dicts
    ("batch_stats" optional: the parameters alone then).

    roi_shape: the bbox RoIAlign output (D, H, W), which sets the order
    of the first fc's input.  Returns {name: torch.Tensor}.
    """
    params = variables["params"]
    stats = variables.get("batch_stats")
    sd = {}

    def put(name, arr):
        sd[name] = torch.from_numpy(np.array(arr, np.float32))

    def conv(src, dst, bias=False):
        put(f"{dst}.weight", _conv(src["kernel"]))
        if bias:
            put(f"{dst}.bias", src["bias"])

    def bn(p, s, dst):
        put(f"{dst}.weight", p["scale"])
        put(f"{dst}.bias", p["bias"])
        if s is not None:
            put(f"{dst}.running_mean", s["mean"])
            put(f"{dst}.running_var", s["var"])

    def sub(s, key):
        return None if s is None else s[key]

    bp, bs = params["backbone"], sub(stats, "backbone")
    if "conv1" in bp:
        conv(bp["conv1"], "backbone.conv1")
        bn(bp["bn1"], sub(bs, "bn1"), "backbone.bn1")
    for name in bp:
        if name.startswith(("enc", "dec")):
            # UNet3D's biased convs keep their names
            conv(bp[name], f"backbone.{name}", True)
        if not name.startswith("layer"):
            continue
        li, bi = name[len("layer"):].split("_")
        dst = f"backbone.layer{li}.{bi}"
        p, s = bp[name], sub(bs, name)
        # conv1-2 in a basic block, conv1-3 in a bottleneck
        for n in (1, 2, 3):
            if f"conv{n}" not in p:
                continue
            conv(p[f"conv{n}"], f"{dst}.conv{n}")
            bn(p[f"bn{n}"], sub(s, f"bn{n}"), f"{dst}.bn{n}")
        if "downsample_conv" in p:
            conv(p["downsample_conv"], f"{dst}.downsample.0")
            bn(p["downsample_bn"], sub(s, "downsample_bn"),
               f"{dst}.downsample.1")

    neck = params["neck"]
    i = 0
    while f"lateral_{i}" in neck:
        conv(neck[f"lateral_{i}"], f"neck.lateral_convs.{i}.conv", True)
        conv(neck[f"fpn_{i}"], f"neck.fpn_convs.{i}.conv", True)
        i += 1

    def numbered(src, prefix):
        i = 0
        while f"{prefix}_{i}" in src:
            yield i, src[f"{prefix}_{i}"]
            i += 1

    # one RPN head under one_rpn: rpn_head_0 alone -> rpn_head
    for s, head in numbered(params, "rpn_head"):
        if "retina_cls" in head:
            for i, p in numbered(head, "cls_conv"):
                conv(p, f"bbox_head.cls_convs.{i}.conv", True)
            for i, p in numbered(head, "reg_conv"):
                conv(p, f"bbox_head.reg_convs.{i}.conv", True)
            for part in ("retina_cls", "retina_reg"):
                conv(head[part], f"bbox_head.{part}", True)
            continue
        dst = "rpn_head" if s == 0 else f"rpn_head_{s + 1}"
        for part in ("rpn_conv", "rpn_cls", "rpn_reg"):
            conv(head[part], f"{dst}.{part}", True)

    def fc_head(src, dst):
        i = 0
        while f"shared_fc_{i}" in src:
            fc = src[f"shared_fc_{i}"]
            kernel = fc["kernel"]
            put(
                f"{dst}.shared_fcs.{i}.weight",
                _fc0(kernel, roi_shape) if i == 0 else _fc(kernel),
            )
            put(f"{dst}.shared_fcs.{i}.bias", fc["bias"])
            i += 1
        for name in ("fc_cls", "fc_reg", "fc_parcellations"):
            if name in src:
                put(f"{dst}.{name}.weight", _fc(src[name]["kernel"]))
                put(f"{dst}.{name}.bias", src[name]["bias"])

    def mask_head(src, dst):
        for i, p in numbered(src, "conv"):
            conv(p, f"{dst}.convs.{i}.conv", True)
        put(f"{dst}.upsample.weight", _deconv(src["upsample"]["kernel"]))
        put(f"{dst}.upsample.bias", src["upsample"]["bias"])
        conv(src["conv_logits"], f"{dst}.conv_logits", True)
        if "conv_res" in src:
            conv(src["conv_res"], f"{dst}.conv_res.conv", True)

    cascade = ("bbox_head_0" in params
               and np.shape(params["bbox_head_0"]["fc_reg"]["kernel"])[-1]
               == 6)

    def head_name(base, s):
        if cascade:
            return f"{base}.{s}"
        return base if s == 0 else f"{base}_{s + 1}"

    for s, head in numbered(params, "bbox_head"):
        fc_head(head, head_name("bbox_head", s))
    for s, head in numbered(params, "mask_head"):
        mask_head(head, head_name("mask_head", s))
    if "semantic_head" in params:
        src = params["semantic_head"]
        for i, p in numbered(src, "lateral"):
            conv(p, f"semantic_head.lateral_convs.{i}.conv", True)
        for i, p in numbered(src, "conv"):
            conv(p, f"semantic_head.convs.{i}.conv", True)
        conv(src["conv_embedding"], "semantic_head.conv_embedding.conv",
             True)
        conv(src["conv_logits"], "semantic_head.conv_logits", True)
    if "refinement_head" in params:
        fc_head(params["refinement_head"], "refinement_head")
    if "refinement_mask_head" in params:
        mask_head(params["refinement_mask_head"], "refinement_mask_head")
    return sd


def load_train_state(state, params, batch_stats, trace, step,
                     roi_shape=(3, 7, 7)):
    """Carries a JAX train state into a port `train.step.TrainState`, in
    place: params and batch_stats (nested numpy dicts) into the model,
    optax's momentum trace (shaped as the params) into SGD's momentum
    buffers, and the step count, which fixes the schedule."""
    model = state.model
    sd = state_dict_from_jax({"params": params, "batch_stats": batch_stats},
                             roi_shape)
    model.load_state_dict(sd, strict=True)
    buffers = state_dict_from_jax({"params": trace}, roi_shape)
    for name, p in model.named_parameters():
        # in the parameter's own storage order (channels_last_3d convs)
        state.optimizer.state[p]["momentum_buffer"] = \
            torch.empty_like(p).copy_(buffers[name])
    state.step = int(step)
    return state
