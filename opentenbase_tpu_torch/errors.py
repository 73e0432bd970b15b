"""Errors of the port."""


class NotPorted(NotImplementedError):
    """A statement or plan shape this package does not run yet.

    The message names the shape. There is no fallback: a shape outside
    the ported slice is refused, never answered by another path."""
