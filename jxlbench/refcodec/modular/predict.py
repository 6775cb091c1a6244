"""Modular predictor ids, property counts and the weighted predictor's
header.

Mirrors modular/encoding/context_predict.h and options.h:21-40; the
predictors themselves run in C (native/modular_decode.c).
"""

from __future__ import annotations

from ..io.fields import Bundle

# Predictor ids (modular/options.h:21-40)
(P_ZERO, P_LEFT, P_TOP, P_AVG0, P_SELECT, P_GRADIENT, P_WEIGHTED, P_TOPRIGHT,
 P_TOPLEFT, P_LEFTLEFT, P_AVG1, P_AVG2, P_AVG3, P_AVG4) = range(14)
NUM_PREDICTORS = 14

NUM_STATIC_PROPERTIES = 2  # channel, group id
# kNumNonrefProperties = 2 static + 13 local + 1 WP (context_predict.h:349)
NUM_NONREF_PROPERTIES = NUM_STATIC_PROPERTIES + 13 + 1
WP_PROP = NUM_NONREF_PROPERTIES - 1


class WeightedHeader(Bundle):
    """weighted::Header (context_predict.h:33-68)."""

    def visit_fields(self, v):
        if v.all_default(self):
            return
        for name, d in (("p1c", 16), ("p2c", 10), ("p3ca", 7), ("p3cb", 7),
                        ("p3cc", 7), ("p3cd", 0), ("p3ce", 0)):
            setattr(self, name, v.bits_val(getattr(self, name), 5, d))
        self.w = [v.bits_val(self.w[i], 4, d)
                  for i, d in enumerate((0xD, 0xC, 0xC, 0xC))]

    def set_default(self):
        self.all_default = True
        self.p1c, self.p2c = 16, 10
        self.p3ca = self.p3cb = self.p3cc = 7
        self.p3cd = self.p3ce = 0
        self.w = [0xD, 0xC, 0xC, 0xC]



