"""The flash-attention experiments and checks of the reference's
``scripts/`` (exp_flash_exp2.py, exp_flash_floor.py, exp_flash_pipelined.py,
bench_flash_ragged.py), ported to the card: each module's ``main()`` runs
as ``python -m sdxl_tpu_torch.scripts.<name>`` and prints its reference
script's lines. ``timing`` holds their two timers."""
