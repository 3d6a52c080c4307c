"""Early-fail schema for user-supplied motor-mixing configuration (PyTorch
counterpart of :mod:`dart_planner_tpu.hardware.mixing_schema`).

Parity rebuild of the reference's pydantic mixing schema
(the reference's hardware/motor_mixing_schema.py:1-82):
validates the ``motor_mixing`` section of a hardware YAML *before* a
:class:`~dart_planner_tpu_torch.hardware.motor_mixer.MotorMixingConfig` is
constructed, so a bad deployment config fails at load time with a field
path instead of at arm time with a singular mixing matrix.
"""

from __future__ import annotations

from typing import Any, Dict, List

from pydantic import BaseModel, Field, field_validator, model_validator

from dart_planner_tpu_torch.hardware.motor_mixer import MotorMixingConfig


class MotorMixingModel(BaseModel):
    """Schema for the ``motor_mixing`` section (reference schema fields
    minus the layout enum — layout here is implied by the positions)."""

    motor_positions: List[List[float]] = Field(
        default=MotorMixingConfig().motor_positions,
        description="4 x [x, y, z] motor positions (m), body frame",
    )
    motor_directions: List[int] = Field(
        default=MotorMixingConfig().motor_directions,
        description="spin directions, +1 CCW / -1 CW",
    )
    pwm_min: float = Field(0.0, ge=0.0, le=1.0)
    pwm_max: float = Field(1.0, ge=0.0, le=1.0)
    pwm_idle: float = Field(0.1, ge=0.0, le=1.0)
    arm_length: float = Field(0.15, gt=0.0)
    yaw_torque_coefficient: float = Field(0.05, gt=0.0)

    @field_validator("motor_positions")
    @classmethod
    def _four_3d_positions(cls, v):
        if len(v) != 4 or any(len(p) != 3 for p in v):
            raise ValueError("motor_positions must be 4 [x, y, z] rows")
        return v

    @field_validator("motor_directions")
    @classmethod
    def _balanced_directions(cls, v):
        if len(v) != 4 or any(d not in (-1, 1) for d in v):
            raise ValueError("motor_directions must be 4 values of +-1")
        if sum(v) != 0:
            raise ValueError(
                "motor_directions must balance (two CW + two CCW), got "
                f"{v} — an unbalanced set cannot null yaw torque"
            )
        return v

    @model_validator(mode="after")
    def _pwm_range_and_controllability(self):
        if not (self.pwm_min <= self.pwm_idle < self.pwm_max):
            raise ValueError(
                "require pwm_min <= pwm_idle < pwm_max, got "
                f"{self.pwm_min}/{self.pwm_idle}/{self.pwm_max}"
            )
        # the geometry must yield a full-rank mixing matrix (all four of
        # thrust/roll/pitch/yaw controllable) — the semantic check the
        # reference schema defers to MotorMixer.validate_configuration
        import numpy as np

        from dart_planner_tpu_torch.hardware.motor_mixer import (
            mixing_matrix_from_geometry,
        )

        B = mixing_matrix_from_geometry(self.to_config())
        if np.linalg.matrix_rank(B) < 4:
            raise ValueError(
                "motor geometry yields a singular mixing matrix "
                "(some thrust/torque axis is uncontrollable)"
            )
        return self

    def to_config(self) -> MotorMixingConfig:
        return MotorMixingConfig(
            motor_positions=[list(p) for p in self.motor_positions],
            motor_directions=list(self.motor_directions),
            pwm_min=self.pwm_min,
            pwm_max=self.pwm_max,
            pwm_idle=self.pwm_idle,
            arm_length=self.arm_length,
            yaw_torque_coefficient=self.yaw_torque_coefficient,
        )


def validate_motor_mixing(raw: Dict[str, Any]) -> MotorMixingConfig:
    """Validate a raw ``motor_mixing`` mapping (e.g. from hardware YAML)
    and return the constructed config; raises pydantic ValidationError
    with field paths on any violation."""
    return MotorMixingModel(**raw).to_config()
