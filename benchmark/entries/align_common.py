"""What the align entries share: handing the scene to the port, the
port's registration settings from a configuration file, and the
reference run over lists of pairs."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import clipper_f64

# the control: the affinity in float8 (the configuration states bfloat16)
# and the rest in bfloat16 (it states float32)
CONTROL = dict(dtype=torch.bfloat16, m_dtype=torch.float8_e4m3fn)
# pairs the reference registers at once: bounds its float64 intermediates
# (about 0.33 GB each at 16 pairs of 40 x 40)
REFERENCE_BATCH = 16


def registration_config(config: dict):
    """The port's RegistrationConfig for a configuration file, as the
    port's submap_align builds it from submap_align.yaml."""
    from roman_tpu_torch.align.clipper import ClipperSolveParams
    from roman_tpu_torch.align.registration import RegistrationConfig

    d = config["defaults"]
    return RegistrationConfig(
        method=config["method"], dim=config["dim"], fusion=config["fusion_method"],
        sigma=d["sigma"], epsilon=d["epsilon"], mindist=d["mindist"],
        epsilon_shape=d["epsilon_shape"], cos_min=config["cosine_min"],
        cos_max=config["cosine_max"], gravity_unc_ang_rad=d["gravity_unc_ang_rad"],
        max_clique=d["max_clique"],
        solver=ClipperSolveParams(n_restarts=d["solver_restarts"]))


def features(subs, device):
    """One robot's packed submaps as the port's SubmapFeatures on device."""
    from roman_tpu_torch.align.invariants import SubmapFeatures

    return SubmapFeatures(*(torch.as_tensor(x, device=device)
                            for x in (subs.centers, subs.ratio, subs.desc, subs.valid)))


def reference(config: dict, subs, pair_i, pair_j, device, rescue: bool,
              unpadded: bool = False, **kw) -> dict:
    """The reference's answers (numpy) to pairs (pair_i[p], pair_j[p]) of
    the two robots' submaps; unpadded caps each pair's rounding at its own
    sizes, as a call on the unpadded pair does. kw: clipper_f64.register's
    dtype and m_dtype."""
    key = np.asarray(pair_i) * len(subs[1].valid) + np.asarray(pair_j)
    uniq, back = np.unique(key, return_inverse=True)
    if len(uniq) < len(key):  # a pair listed twice is registered once
        out = reference(config, subs, uniq // len(subs[1].valid), uniq % len(subs[1].valid),
                        device, rescue, unpadded, **kw)
        return {k: v[back] for k, v in out.items()}
    p = clipper_f64.Params.from_config(config)
    out = {k: [] for k in ("sel", "count", "T", "F", "rescued", "live")}
    for s in range(0, len(pair_i), REFERENCE_BATCH):
        a, b = pair_i[s:s + REFERENCE_BATCH], pair_j[s:s + REFERENCE_BATCH]
        side1 = [torch.as_tensor(x[a], device=device)
                 for x in (subs[0].centers, subs[0].ratio, subs[0].desc, subs[0].valid)]
        side2 = [torch.as_tensor(x[b], device=device)
                 for x in (subs[1].centers, subs[1].ratio, subs[1].desc, subs[1].valid)]
        steps = None
        if unpadded:
            steps = torch.as_tensor(np.minimum(np.minimum(subs[0].sizes[a], subs[1].sizes[b]),
                                               p.max_clique), device=device)
        res = clipper_f64.register(*side1, *side2, p, rescue=rescue, max_steps=steps, **kw)
        for k in out:
            out[k].append(res[k].double().cpu().numpy() if res[k].is_floating_point()
                          else res[k].cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}
