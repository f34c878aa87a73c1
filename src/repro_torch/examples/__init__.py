"""The paper's end-to-end examples on the port (the port's ``examples/``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_cc_policies [--arch A]
    PYTHONPATH=src python -m repro_torch.examples.serve_cluster [--replicas N]
    PYTHONPATH=src python -m repro_torch.examples.loader_and_offload
    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]

Each prints what the reference's script of the same name prints, runs on
the card unless given ``--device cpu``, and does its work in
``main(argv=None)``: importing a module does nothing.
"""
