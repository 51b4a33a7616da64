"""Codecs of the port; importing this package registers them all."""
from repro_torch.algos import (ans, bitpack, delta, deltastride,  # noqa: F401
                               dictionary, float2int, rle, stringdict)
