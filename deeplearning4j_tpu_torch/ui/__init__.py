"""UI server.

Parity: reference `deeplearning4j-ui` (737 LoC) — Dropwizard `UiServer`
with `TsneResource` (coords upload + scatter view), `WeightResource`
(weight histograms), `NearestNeighborsResource` (VPTree over uploaded
vectors), `ApiResource`, FreeMarker views. Here, as in the JAX package's
`ui/`: stdlib ThreadingHTTPServer + one inline HTML view; JSON REST
endpoints.
"""

from deeplearning4j_tpu_torch.ui.server import UiServer

__all__ = ["UiServer"]
