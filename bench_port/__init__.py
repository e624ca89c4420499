"""The benchmark of gkl_tpu_torch: GATK active regions through the port's
three calls on one CUDA card.  ``run.py`` runs one cell; see its docstring."""
