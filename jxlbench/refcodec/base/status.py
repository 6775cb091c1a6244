"""Error handling for libjxl_tpu.

The reference uses a bool-like ``Status`` with JXL_FAILURE macros
(lib/jxl/base/status.h). In Python we use exceptions; ``NotEnoughBytes``
mirrors StatusCode::kNotEnoughBytes so suspendable decoders can catch it
and ask the caller for more input.
"""


class JXLError(Exception):
    """Generic codestream / usage error (JXL_FAILURE analog)."""


class NotEnoughBytes(JXLError):
    """Input truncated mid-structure; caller may supply more bytes and retry."""

