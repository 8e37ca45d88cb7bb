"""Cohort orchestration (a frozen copy of the port's meta/): incubator,
group assembly; the device waves' stand-in never engages a device."""
