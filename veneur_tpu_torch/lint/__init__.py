"""The port's lint package. It holds the runtime twins so far: the
ledger audit (``ledger_audit.py``), which checks a conservation identity
over live counters, and the buffer census (``buffer_census.py``), which
checks that live torch tensor storage settles back to its baseline. The
static passes they pair with stay in the JAX package's linter; porting
them is the next lint slice."""
