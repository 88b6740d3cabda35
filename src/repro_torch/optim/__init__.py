"""Optimization helpers: the uplink codecs (``compression``)."""
