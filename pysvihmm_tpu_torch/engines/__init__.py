from . import base, batch_sgd, batch_vb, gibbs, metaobs, svi

__all__ = ["base", "batch_sgd", "batch_vb", "gibbs", "metaobs", "svi"]
