"""The traffic kind "closed_volumes": the generator that reads a mix
file (`traffic/<mix>.json`) of this kind, makes its requests on the
device from the run's seed, and serves one request.

A mix of this kind is a closed loop of `clients` clients (one today),
each sending its next request when the last one's outputs are on the
host, from a pool of `pool` seeded volumes.  A volume is
SWI-like: a smooth tissue field over a fine texture, with spherical
hypointense foci (microbleeds) of drawn radius and contrast, normalised
by the configuration's img_norm_cfg into three channels; each further
scale of the mix is its trilinear resize (the 1.5x twin).  Every seed
gives the same sizes and the same number of foci per volume, in other
places: the work of a request does not depend on the seed.  A request is
one `Flagship.simple_test` call (which runs the cascade for the cascade
types), finished when its outputs are copied to the host.

A kind is a module `kinds/<kind>.py` with `make_pool`, `order` and
`request`, as here; the harness loads the one a mix names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# what a request hands back, for the host copy and the check
OUTPUTS = ("dets", "labels", "valid", "mask_logits")


def _volume(gen, dhw, spec, device):
    """One intensity volume (1, 1, D, H, W) float32 in [0, 1]."""
    d, h, w = dhw
    tex = spec["texture"]
    coarse = torch.randn((1, 1, *tex["coarse"]), generator=gen,
                         device=device)
    vol = F.interpolate(coarse, size=dhw, mode="trilinear",
                        align_corners=False)
    vol = tex["base"] + tex["coarse_sd"] * vol
    vol += tex["fine_sd"] * torch.randn((1, 1, d, h, w), generator=gen,
                                        device=device)
    foci = spec["foci"]
    n = foci["count"]
    u = torch.rand((n, 5), generator=gen, device=device).cpu()
    lo, hi = foci["radius_vox"]
    for cz, cy, cx, ru, cu in u.tolist():
        r = lo + (hi - lo) * ru
        # the depth axis is twice as coarse as the in-plane ones
        rz = max(r / 2, 1.0)
        z0, y0, x0 = cz * (d - 1), cy * (h - 1), cx * (w - 1)
        zs = slice(max(int(z0 - rz) - 1, 0), min(int(z0 + rz) + 2, d))
        ys = slice(max(int(y0 - r) - 1, 0), min(int(y0 + r) + 2, h))
        xs = slice(max(int(x0 - r) - 1, 0), min(int(x0 + r) + 2, w))
        zz = torch.arange(zs.start, zs.stop, device=device)[:, None, None]
        yy = torch.arange(ys.start, ys.stop, device=device)[None, :, None]
        xx = torch.arange(xs.start, xs.stop, device=device)[None, None, :]
        inside = (((zz - z0) / rz) ** 2 + ((yy - y0) / r) ** 2
                  + ((xx - x0) / r) ** 2) <= 1.0
        depth = foci["contrast"][0] + (foci["contrast"][1]
                                       - foci["contrast"][0]) * cu
        vol[0, 0, zs, ys, xs] -= inside * depth
    return vol.clamp_(0.0, 1.0)


def _normalise(vol, norm, dtype):
    """(1, 1, D, H, W) intensities in [0, 1] -> (1, 3, D, H, W) in the
    configuration's normalisation, in `dtype`."""
    mean = torch.tensor(norm["mean"], device=vol.device).view(1, 3, 1, 1, 1)
    std = torch.tensor(norm["std"], device=vol.device).view(1, 3, 1, 1, 1)
    return ((vol * 255.0 - mean) / std).to(dtype)


def make_pool(mix, config, seed, device, dtype):
    """The mix's pool: a list of requests, each {"imgs": ..., "imgs_2":
    ...} with one (1, 3, D, H, W) tensor per scale of the mix, in the
    configuration's img_norm_cfg."""
    img_norm = config["img_norm_cfg"]
    gen = torch.Generator(device=device).manual_seed(seed)
    dhw = tuple(mix["volume"]["shape"])
    pool = []
    for _ in range(mix["pool"]):
        vol = _volume(gen, dhw, mix["volume"], device)
        req = {}
        for i, factor in enumerate(mix["volume"]["scales"]):
            key = "imgs" if i == 0 else f"imgs_{i + 1}"
            if factor == 1.0:
                req[key] = _normalise(vol, img_norm, dtype)
            else:
                size = tuple(int(round(n * factor)) for n in dhw)
                twin = F.interpolate(vol, size=size, mode="trilinear",
                                     align_corners=False)
                req[key] = _normalise(twin, img_norm, dtype)
        pool.append(req)
    return pool


def order(mix, seed):
    """The pool index of each request, endlessly: the pool in a seeded
    order, reshuffled each time round."""
    gen = torch.Generator().manual_seed(seed + 1)
    while True:
        yield from torch.randperm(mix["pool"], generator=gen).tolist()


def request(det, item, mark=None):
    """One request on the device: the detector's outputs for one pool
    entry, with the `mark` hook at its stage boundaries."""
    out = det.simple_test(item, mark=mark)
    return {k: out[k] for k in OUTPUTS}
