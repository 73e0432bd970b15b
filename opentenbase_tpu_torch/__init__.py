"""opentenbase_tpu_torch: the PyTorch/CUDA port of opentenbase_tpu.

It mirrors the reference package's layout (``sql``, ``plan``,
``catalog``, ``storage``, ``ops``, ``executor``, ``engine``) and runs on
an NVIDIA GPU through hand-written CUDA kernels (``csrc/``). It imports
neither jax nor the reference package: the pure-Python modules it needs
are copies. Shapes outside the ported slice raise :class:`NotPorted`.

    from opentenbase_tpu_torch import Cluster
    s = Cluster(num_datanodes=2).session()      # runs on cuda:0
    s.execute("create table t (a int, b bigint) distribute by roundrobin")
    s.query("select sum(b) from t where a < 10")
"""

from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.engine import Cluster, Result, Session, SQLError

__all__ = ["Cluster", "NotPorted", "Result", "SQLError", "Session"]
