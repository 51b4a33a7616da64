"""Codecs of the port; importing this package registers them all.

ANS and StringDict (the Non-Parallel kernel's codecs) are not ported yet."""
from repro_torch.algos import (bitpack, delta, deltastride, dictionary,  # noqa: F401
                               float2int, rle)
