"""Kernel B2's share of its roofline at the flows' width: ``b2_roofline.sir``'s reader
(the rows and the width come from the cell's counters and shape)."""

from h100_bench import harness

read = harness.load_module("metrics", "b2_roofline.sir").read
