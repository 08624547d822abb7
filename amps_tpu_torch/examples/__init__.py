"""Walkthroughs of the port, each a ``main(device=None)``:
``bs_loopback_demo`` (an origination over the channelized band) and
``call_lifecycle_demo`` (a whole call against the mobile simulator)."""
