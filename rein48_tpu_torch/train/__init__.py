# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
