"""The striped multi-device encode on ``torch.distributed``: the (batch,
stripe) mesh (:mod:`.mesh`), the stripe's coefficient step and pack
(:mod:`.stripes`), and ``ShardedEncoder`` (:mod:`.encode`)."""
