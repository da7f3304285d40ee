"""Tenancy: only the SLO tiers (``slo.py``) are ported so far.

Kept import-free on purpose: ``api.policy`` imports ``tenancy.slo`` and
``tenancy.slo`` imports ``core.arbiter``; a package ``__init__`` that pulled
in more would recreate the reference's ``tenancy`` ↔ ``core`` import cycle.
"""
