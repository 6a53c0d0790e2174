"""The API machinery the port's trainer needs to watch its node (a copy
of the part of ``nos_tpu/kube/`` the lifecycle notice watcher reaches):
typed ``Node`` objects, an in-process ``ApiServer`` with watch streams,
the controller runtime (``Manager``, ``Controller``), and the JSON/HTTP
facade (``ApiHttpServer``) with its client (``RemoteApiServer``), whose
wire is the reference's byte for byte. No torch, no JAX."""
