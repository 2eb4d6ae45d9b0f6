"""Annotated-hex fixture DSL.

The reference test suite builds malformed binary fixtures from readable,
commented hexdumps (``test/hex_decode``: strip everything after ``|``,
concatenate, unhexlify).  The same tiny DSL is reproduced here so the error
matrices can be written as self-documenting vectors.
"""

from __future__ import annotations

import binascii


def hex_to_bytes(text: str) -> bytes:
    """Convert an annotated hexdump to bytes.

    Each line may carry a ``| comment``; whitespace is insignificant.
    """
    hex_digits = []
    for line in text.splitlines():
        data = line.split("|", 1)[0]
        hex_digits.append("".join(data.split()))
    return binascii.unhexlify("".join(hex_digits))
