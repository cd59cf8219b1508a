"""Plain reference of the ``skewt_d400`` configuration: the ``skewt_d144``
configuration's plain reference (``configs/skewt_d144.py``: the skew-t
sensor-network simulator, the UKF-assisted EDH and LEDH flow particle
filters over batched trials, the TF32 control and ``compare``) at d = 400.
That reference builds its √d × √d lattice from the configuration's ``d``, so
the same code holds for the 20×20 lattice; it is plain PyTorch and imports
no code of the program."""

from h100_bench import harness

_ref = harness.load_module("configs", "skewt_d144")
simulate, PlainFilter, control, compare = (_ref.simulate, _ref.PlainFilter, _ref.control,
                                           _ref.compare)
