"""Operations and bytes of one CSP model gather (`ops.csp._csp_model_gather`)
from its argument shapes: params (a CspParams of tilt angles (..., T), axis
angles, tilt shifts, eulers (..., P, 3), positions, defocus offsets), mask
points (G, 2), the padded reference spectrum Fref (m, m, m//2+1) complex, n.

The algorithm: one trilinear, Friedel-aware value of Fref per (series,
tilt, particle, point): 8 corners, each a real weight (2 multiplies) times a
complex value added (4), 48 float32 operations a point. Its inputs are read
once (Fref whole, the points, the parameters) and the (..., T, P, G)
complex64 result written once, which bounds it."""

import math

from portbench.lib import peaks


def least_seconds(shapes):
    params, pts, fref = shapes[0], shapes[1], shapes[2]
    tilt, eulers = params[0], params[3]
    lead, T = tilt[:-1], tilt[-1]
    P = eulers[-2]
    G = pts[0]
    points = math.prod(lead) * T * P * G
    nbytes = (8 * points + 8 * math.prod(fref) + 4 * math.prod(pts)
              + sum(4 * math.prod(s) for s in params))
    return peaks.least_seconds([(48.0 * points, peaks.FP32_FLOPS)], nbytes)
