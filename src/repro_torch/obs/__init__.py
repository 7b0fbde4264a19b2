"""Observability of the port: the replan ledger (``ledger``) and the
dispatch hook with its null recorder (``trace``); the full recorder is a
later slice (ROADMAP A11)."""
