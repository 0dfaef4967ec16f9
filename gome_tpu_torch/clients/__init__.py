"""Client drivers — the reference's L6 layer (SURVEY §1): standalone
programs that exercise the service over gRPC.

  load_client   — doorder.go:18-60's randomized order blaster
  cancel_client — delorder.go:14-38's single cancel

Run as modules:  python -m gome_tpu_torch.clients.doorder [host:port]
                 python -m gome_tpu_torch.clients.delorder [host:port]

The port of ``gome_tpu/clients``. The wire is the reference's, so these
drive a server of either package.
"""

from .doorder import load_client
from .delorder import cancel_client

__all__ = ["load_client", "cancel_client"]
