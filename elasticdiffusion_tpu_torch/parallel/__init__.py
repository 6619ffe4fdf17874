"""Several GPUs and large sizes: the ('data', 'views') mesh of processes and
its collectives (``sharding``), and ``halo_decode``, whose stage b runs in
bands over the mesh or, on one GPU, monolithic, streamed or in bands."""
