"""Several devices and several processes: the ``--mesh`` engine
(``mesh``) and multi-host runs over ``torch.distributed``
(``distributed``)."""
