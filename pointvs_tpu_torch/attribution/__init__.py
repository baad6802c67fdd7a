"""Attribution: per-atom scores of a trained model (``attribution``)."""
