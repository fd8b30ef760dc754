"""Step builders of the port. Only the serving builders are ported
(``steps.make_prefill_step``, ``steps.make_serve_step``); the train step,
optimizer and sharding wait for the training slice (ROADMAP A10)."""
