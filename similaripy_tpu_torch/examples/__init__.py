"""The port's end-to-end examples: the item-item recommender pipeline
(``item_item_recommender``, run as ``python -m
similaripy_tpu_torch.examples.item_item_recommender``) and the generator
of its notebook form (``make_notebook``)."""
