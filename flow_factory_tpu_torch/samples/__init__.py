from .samples import (
    BaseSample,
    I2AVSample,
    I2ISample,
    I2VSample,
    ImageConditionSample,
    T2AVSample,
    T2ISample,
    T2VSample,
    V2VSample,
    VideoConditionSample,
    stack_samples,
)

__all__ = [
    "BaseSample",
    "ImageConditionSample",
    "VideoConditionSample",
    "T2ISample",
    "T2VSample",
    "T2AVSample",
    "I2ISample",
    "I2VSample",
    "I2AVSample",
    "V2VSample",
    "stack_samples",
]
