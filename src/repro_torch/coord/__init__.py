from .serving_front import InferenceRequest, ServingFrontend

__all__ = ["InferenceRequest", "ServingFrontend"]
