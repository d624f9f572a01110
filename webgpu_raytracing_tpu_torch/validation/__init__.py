"""Cross-implementation validation tools.

:mod:`wgsl_sim` is a scalar, per-pixel transliteration of the reference's
WGSL megakernel semantics — an independent oracle for the cross-reference
RMSE evidence demanded by the north star (BASELINE.md: "≤ 1e-2 RMSE vs
WebGPU reference at equal spp").
"""
