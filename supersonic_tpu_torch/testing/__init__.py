from .operation_testing import OperationTest, check_operation, sweep_capacities
