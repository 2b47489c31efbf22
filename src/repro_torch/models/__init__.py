from repro_torch.models.model import (Model, abstract_decode_state,
                                      abstract_params, build)

__all__ = ["Model", "abstract_decode_state", "abstract_params", "build"]
