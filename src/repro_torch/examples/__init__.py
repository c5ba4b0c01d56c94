"""The port's four examples, each run as ``python -m
repro_torch.examples.<name>`` (counterparts of the scripts under
``examples/``): ``quickstart``, ``sawtooth_analysis``, ``train_lm`` and
``serve_lm``. Each does its work in ``main(argv=None)`` and nothing on
import, and runs on the card unless ``--device cpu`` is given."""
