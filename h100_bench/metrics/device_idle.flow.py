"""The device's idle share of the traced window: ``device_idle.sir``'s reader."""

from h100_bench import harness

read = harness.load_module("metrics", "device_idle.sir").read
