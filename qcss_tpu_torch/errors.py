"""Exception types.

The reference defines ``InvalidCodeError`` and ``UnsupportedGateError``
(reference: errors.py:5-8) but *uses* two additional exception classes that it
never defines (``UnsupportedQECCError`` / ``UnsupportedProgramError``,
reference: ftqc.py:44,47,118 — a latent NameError). All four are defined
properly here.
"""


class QCSSError(Exception):
    """Base class for all qcss_tpu errors."""


class InvalidCodeError(QCSSError):
    """The given parity-check matrices do not define a valid CSS code."""


class UnsupportedGateError(QCSSError):
    """The logical gate is not implementable fault-tolerantly by this code."""


class UnsupportedQECCError(QCSSError):
    """The QECC does not satisfy the requirements of the FT transpiler."""


class UnsupportedProgramError(QCSSError):
    """The program contains instructions the FT transpiler cannot rewrite."""
