"""One pass of the CSP mode schedule over a batch of tilt series, then the
insertion of every projection it refined: the hot loop of a CSPT iteration.

Set-up makes the series (gen/csp.py) and derives what the system's
pipeline derives before its loop: the band's mask points
(`ops.refine3d.make_mask_points`), the reference's padded spectrum
(`ops.fourier_slice.volume_to_fourier`) and each window's samples at the
mask points. A unit is `ops.csp.csp_refine_batch` over the series,
vectorized, from the start parameters, then `ops.reconstruct.
accumulate_matrices` of every (series, tilt, particle) window at its
refined pose, residual shift and depth defocus, halves by particle.

The judgment holds two numbers against their limits:
  acc_rel_err     the largest relative L2 gap between an accumulator
                  (numerator or denominator of either half) the system
                  filled and the one the plain reference fills, in float64,
                  from the same windows at the refined parameters, below
                  EDGE wavenumbers inside the insertion's Nyquist sphere
                  (whether a sample on that sphere is kept is decided by
                  the last bit of its float32 coordinates);
  csp_score_loss  how far the refined parameters' mean correlation with the
                  true volume falls below the true parameters', per series,
                  as a share of the latter, averaged over the series.
"""

from __future__ import annotations

import torch

from portbench.gen import csp as gen_csp
from portbench.reference import fourier as rf
from portbench.reference import recon, score

LAYERS = [
    ("pyp_tpu_torch.ops.csp", "csp_refine_batch", "csp.csp_refine_batch"),
    ("pyp_tpu_torch.ops.csp", "_csp_model_gather", "csp._csp_model_gather"),
    ("pyp_tpu_torch.ops.reconstruct", "accumulate_matrices",
     "reconstruct.accumulate_matrices"),
]
RATE = "csp_projections_per_s"
EDGE = 2    # wavenumbers of the padded grid left out inside its Nyquist sphere
KEYS = ("tilt", "axis", "shifts", "eulers", "pos", "df_offsets")


class Unit:
    def __init__(self, cfg, mix, seed, device):
        from pyp_tpu_torch.ops import csp, fourier_slice, refine3d
        from pyp_tpu_torch.ops import reconstruct as rec

        self.csp, self.rec = csp, rec
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, device
        self.box, self.pixel = cfg["box"], cfg["pixel"]
        self.g = gen_csp.make(seed, device=device, **cfg)
        S, T, P = cfg["series"], cfg["tilts"], cfg["particles_per_series"]
        self.mask = torch.as_tensor(refine3d.make_mask_points(
            self.box, self.pixel, *cfg["band"]), device=device)
        self.Fref = fourier_slice.volume_to_fourier(self.g["volume"])
        self.xv = torch.stack([csp.gather_2d_hermitian_batched(
            fourier_slice.image_to_fourier(self.g["windows"][s]), self.mask)
            for s in range(S)])
        self.params = csp.CspParams(*(self.g["start"][k] for k in KEYS))
        self.df = self.g["tilt_df"][..., None].expand(S, T, 2).contiguous()
        self.tw = torch.ones((S, T), device=device)
        self.valid = torch.ones((S, T, P), device=device)
        self.offsets, self.spin = csp.build_mode_offsets(tuple(mix["modes"]), None)
        self.sub = (torch.arange(S * T * P, device=device) % P) % 2
        self.weights = torch.ones(S * T * P, device=device)
        self.work = S * T * P
        self.last = None

    def run(self):
        csp, b = self.csp, self.box
        refined = csp.csp_refine_batch(
            self.params, self.xv, self.g["centres"], self.df, self.mask,
            self.Fref, self.tw, self.valid, self.offsets, self.spin,
            tuple(self.mix["modes"]), b, self.pixel,
            iters_per_mode=self.mix["iters_per_mode"], series_vmap=True)[0]
        with torch.no_grad():
            R = csp.effective_rotations(refined).reshape(-1, 3, 3)
            shifts = -(csp.project_positions(refined)
                       - self.g["centres"]).reshape(-1, 2)
            df = (self.g["tilt_df"][:, :, None]
                  + csp.particle_depth(refined) * self.pixel).reshape(-1)
            acc = self.rec.accumulate_matrices(
                self.g["windows"].reshape(-1, b, b), R, shifts, df, self.sub,
                self.weights, b, self.pixel)
        self.last = (refined, acc)

    def release(self):
        refined, acc = self.last
        self.result = ({k: v.detach() for k, v in zip(KEYS, refined)}, tuple(acc))
        self.last = self.xv = self.Fref = self.params = None

    def _reference_inputs(self):
        pts = rf.band_points(self.box, self.pixel, *self.cfg["band"], self.dev,
                             torch.float64)
        wins = self.g["windows"]
        xv = torch.stack([rf.gather_2d(rf.image_to_fourier(wins[s].to(torch.float64)), pts)
                          for s in range(wins.shape[0])])
        return pts, xv

    def reference_acc(self, params, round_to=None, dtype=torch.float64):
        g = {k: v.to(torch.float64) for k, v in params.items()}
        _, proj, depth = score.csp_geometry(g["tilt"], g["axis"], g["shifts"],
                                            g["eulers"], g["pos"])
        # the poses in float32, as the insertion's Nyquist-sphere decisions
        # are taken on them (reference/recon.py)
        g32 = {k: v.to(torch.float32) for k, v in params.items()}
        R = score.csp_geometry(g32["tilt"], g32["axis"], g32["shifts"],
                               g32["eulers"], g32["pos"])[0]
        df = (self.g["tilt_df"].to(torch.float64)[:, :, None]
              + depth * self.pixel).reshape(-1)
        ctf_args = torch.stack([df, df, torch.zeros_like(df)], 1)
        b = self.box
        num, den = recon.accumulate(
            self.g["windows"].reshape(-1, b, b), R.reshape(-1, 3, 3),
            -(proj - self.g["centres"].to(torch.float64)).reshape(-1, 2),
            ctf_args, self.sub, self.weights, 2, self.pixel,
            round_to=round_to, dtype=dtype)
        return (num[0], den[0], num[1], den[1])

    def judge(self, ref_acc=None, params=None, acc=None):
        params = self.result[0] if params is None else params
        acc = self.result[1] if acc is None else acc
        ref_acc = ref_acc or self.reference_acc(params)
        edge = self.box - EDGE      # the padded grid's Nyquist radius is the box
        err = max(recon.rel_err(a, r, edge) for a, r in zip(acc, ref_acc))
        pts, xv = self._reference_inputs()
        Fvol = rf.volume_to_fourier(self.g["volume"].to(torch.float64), 2)
        args = (xv, pts, self.g["centres"], self.g["tilt_df"])
        s_true = score.csp_scores(*args, self.g["true"], Fvol, self.box, self.pixel)
        s_prog = score.csp_scores(*args, params, Fvol, self.box, self.pixel)
        loss = float(((s_true - s_prog) / s_true).mean())
        return {"acc_rel_err": err, "csp_score_loss": loss}

    def unchanged_params(self):
        return dict(self.g["start"])
