"""The port's counterparts of the reference's ``examples/*.py``, each run as
``python -m repro_torch.examples.<name> [--device cpu]`` (the card unless
``--device cpu`` is given): ``quickstart`` and ``reconfigure_live`` build
the reference's deployments from its seeds and print what its examples
print; ``serve_decode`` and ``train_ec_checkpoint`` run ``launch.serve`` and
``launch.train`` with the reference example's arguments and assertions.
Each has a ``main(argv)``."""
