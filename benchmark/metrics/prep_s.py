"""Seconds of the program's prep in the set-up, by the host's clock, the
device synchronised at both ends: kernel A's MFCC of every clip
(``batched_mfcc_device``), the split, and ``poison/badnets.py``'s patch."""


def read(r):
    return r.prep_s
