"""PlanCheck for the port: ProfileInfer and its diagnostics.

Copies of ``repro.core.analysis.diag`` and ``repro.core.analysis.infer``.
PlanVerify (``verify``), its mutation suite and the matrix driver are
not copied yet.
"""
