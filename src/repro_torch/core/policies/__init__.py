"""Tuning policies of the port: the protocol and CARAT. The reference's
Dial, Magpie, Static and per-client policies are not ported yet."""
