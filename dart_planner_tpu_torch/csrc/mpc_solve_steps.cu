// Kernel B1 at five or more horizon steps a lane (S = kDyn), compiled apart
// from the one to four of mpc_solve.cu so that its loops over a lane's
// slots, whose count is read at run time, stay rolled (mpc_solve.cu's
// header says why). Defines mpc_launch_run_time_steps, which mpc_solve.cu's
// mpc_solve_launch calls from N = 129 on.

#define B1_RUN_TIME_STEPS
#include "mpc_solve.cu"
