"""Device meshes, the collectives every mesh route reduces through, and
the multi-process bring-up over ``torch.distributed`` — the port of the
reference's ``parallel/`` package."""
