"""The roofline: the op-cost counter (``op_cost``) and the H100 terms built
on it (``analysis``), the reference's ``repro.roofline``."""
