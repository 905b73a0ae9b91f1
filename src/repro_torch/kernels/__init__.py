"""Kernel ops of the port: each TPU kernel of ``repro.kernels`` becomes a
hand-written Hopper kernel (sources under ``<op>/csrc/``, built by
``_build.py``) beside a plain-torch version of the same function."""
