"""Optimization: the uplink codecs (``compression``), the functional
optimizers (``optimizers``, ``adafactor``) and learning-rate
``schedules``."""
