"""Adapt-on-request serving: the engine, the request grouping front end and
the ``serve-bench`` load generator."""
