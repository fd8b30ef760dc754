"""Protocol invariant analyzers (ISSUE 8).

Static half: ``astlint`` (engine) + ``invariants`` (rule pack), run via
``python -m repro_torch.analysis`` — stdlib-only, imports
nothing from the protocol modules.

Runtime half: ``sanitizer`` (quorum/tag/vocabulary checks on live
``Network`` traffic) + ``linearize`` (post-hoc Wing–Gong-style tag-order
linearizability over recorded histories), enabled with
``DSSParams.sanitize=True`` or ``REPRO_SANITIZE=1``.

This ``__init__`` intentionally imports neither half: the lint CLI must
stay importable without numpy, and the sanitizer pulls the core package.
"""
