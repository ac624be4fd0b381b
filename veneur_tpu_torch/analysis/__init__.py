"""Offline analysis harnesses (the reference's ``tdigest/analysis``
role): statistical accuracy studies that emit CSV artifacts for
operator review rather than pass/fail test assertions."""
